"""Decision-forest training: one histogram grower for three families (torch).

Mirrors ``repro/core/train.py``.  One depth-wise, histogram-based tree
grower drives all three model families through their gradients:

  randomforest   g = y * w, h = w (Poisson(1) bootstrap weights w,
                 per-tree feature subsampling); leaf = G / H
  xgboost        logistic loss: p = sigmoid(margin), g = p - y,
                 h = p (1 - p); leaf = -eta G / (H + lambda)
  lightgbm       xgboost + GOSS (keep the top-a fraction by |g|, sample a
                 b fraction of the rest, upweighted by (1 - a) / b)

Features are quantile-binned once (``num_bins`` bins, NaN in a MISSING
slot ``num_bins``), and the split search learns each node's default
direction.  The grower is factored so that the same per-level functions
run on a resident binned matrix (``train_forest``) and on one streamed
page batch by page batch from the store (``db/train.py``):

  * ``bin_features`` and ``route_level`` run on the tensors' device (the
    card, or the CPU), in exact integer and comparison arithmetic, so a
    batch at a time and the whole array agree bit for bit;
  * the gradient / hessian histograms accumulate on the HOST in float64
    through ``np.add.at`` in global row order (``hist_update``).
    ``np.add.at`` applies its updates one after another in element order,
    so consecutive row slices in order perform the float additions of
    one whole-array call, for any batching.  Atomic adds on the card
    would add in an order of their own, and float addition does not
    associate, so the histograms stay on the host;
  * split search, leaf values, gradients and sampling are host functions
    (numpy, and ``torch.sigmoid`` on the CPU) of those histograms.

So ``train_forest`` and the streamed trainer give bit-identical forests
given the same bin edges, for any tier, format and batch geometry.

Against the reference (``docs/torch_training.md``): the per-tree draws
come from ``core/prng.py``, a numpy copy of JAX's threefry draws, so a
seed names the same bootstrap, feature subset and GOSS sample; the GOSS
threshold copies ``jnp.quantile``'s linear method in float32, with the
fused multiply-add that XLA's CPU backend makes of its last step.
Regression forests of all three families equal the reference's bit for
bit.  Classification differs in the sigmoid: ``torch.sigmoid`` and XLA's
logistic differ by one or two ulps on ~0.4 % of float32 inputs, so g / h
differ by ulps; the tests hold the same splits and leaves within 1e-6.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.forest import (Forest, make_forest, num_internal,
                                     num_leaves)

__all__ = [
    "TrainConfig",
    "quantile_bin_edges",
    "edges_from_sample",
    "bin_features",
    "train_forest",
    "grow_forest_scanned",
    "route_level",
    "hist_update",
]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model_type: str = "xgboost"          # randomforest | xgboost | lightgbm
    task: str = "classification"         # classification | regression
    num_trees: int = 10
    max_depth: int = 8
    learning_rate: float = 0.1           # GBDT shrinkage (ignored by RF)
    reg_lambda: float = 1.0              # L2 on leaf weights (0 for RF)
    min_child_weight: float = 1.0
    min_split_gain: float = 0.0
    num_bins: int = 64
    colsample: float = 1.0               # RF per-tree feature subsampling
    goss_top: float = 0.2                # LightGBM GOSS a
    goss_rest: float = 0.1               # LightGBM GOSS b
    seed: int = 0


# ---------------------------------------------------------------------------
# Quantile binning (host numpy, once per dataset)
# ---------------------------------------------------------------------------


def _column_edges(col: np.ndarray, num_bins: int) -> np.ndarray:
    """Interior edges [num_bins - 1] of one feature column (NaNs removed):
    strictly increasing, duplicate quantiles collapsed to +inf."""
    qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
    if col.size == 0:
        return np.full((num_bins - 1,), np.inf, np.float32)
    e = np.quantile(col, qs).astype(np.float32)
    e = np.where(np.diff(np.concatenate([[-np.inf], e])) > 0, e, np.inf)
    return np.sort(e)


def quantile_bin_edges(x: np.ndarray, num_bins: int) -> np.ndarray:
    """Per-feature interior bin boundaries [F, num_bins - 1] float32.

    x falls in bin b iff edges[b-1] <= x < edges[b]; NaN -> MISSING.
    A constant feature gets +inf edges (bin 0 only: unsplittable)."""
    F = x.shape[1]
    edges = np.empty((F, num_bins - 1), np.float32)
    for f in range(F):
        col = x[:, f]
        edges[f] = _column_edges(col[~np.isnan(col)], num_bins)
    return edges


def edges_from_sample(sample: np.ndarray, num_bins: int) -> np.ndarray:
    """Edges from a [S, F] row sample (the streamed sketch's finalizer)."""
    return quantile_bin_edges(np.asarray(sample, np.float32), num_bins)


def bin_features(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """[N, F] float -> [N, F] int32 bin ids on ``x``'s device; NaN ->
    ``num_bins`` (MISSING).

    The reference counts ``sum(x >= e)`` over a materialised
    [N, F, num_bins - 1] comparison; a right-sided ``searchsorted`` of each
    feature's sorted edges counts the same edges <= x without it (+inf
    rows count every edge, +inf edges included; -inf rows none)."""
    e = edges.to(x.device, torch.float32)
    num_bins = e.shape[1] + 1
    xt = x.to(torch.float32).t().contiguous()            # [F, N]
    b = torch.searchsorted(e.contiguous(), xt, right=True, out_int32=True)
    b = b.t()
    return torch.where(torch.isnan(x), torch.tensor(num_bins, dtype=b.dtype,
                                                    device=b.device), b)


# ---------------------------------------------------------------------------
# Shared per-level machinery: routing, histogram update, split search
# ---------------------------------------------------------------------------


def route_level(bins: torch.Tensor, node_of: torch.Tensor, feat, sbin, dleft,
                term, *, level: int, num_bins: int) -> torch.Tensor:
    """Route rows through level ``level``'s recorded splits (int32).

    bins [rows, F] integer; node_of [rows] int32 dense positions at
    ``level``; feat / sbin / dleft / term [2^level] that level's split
    parameters (any array-like; moved to ``bins``' device).  Terminal
    nodes pass every row left, so a terminal chain lands in one leaf."""
    dev = bins.device
    feat = torch.as_tensor(feat, device=dev).long()
    sbin = torch.as_tensor(sbin, device=dev).to(torch.int32)
    dleft = torch.as_tensor(dleft, device=dev).bool()
    term = torch.as_tensor(term, device=dev).bool()
    n_nodes = 1 << level
    first = n_nodes - 1
    local = torch.clamp(node_of.long() - first, 0, n_nodes - 1)
    my_bin = torch.take_along_dim(bins, feat[local][:, None], dim=1)[:, 0]
    my_bin = my_bin.to(torch.int32)
    go_left = torch.where(my_bin == num_bins, dleft[local],
                          my_bin <= sbin[local])
    go_left = go_left | term[local]
    return 2 * node_of.to(torch.int32) + 1 + (1 - go_left.to(torch.int32))


#: rows a ``np.add.at`` call of ``hist_update`` takes, so that its index
#: and value arrays (F int64 / float64 entries a row) stay in the CPU's
#: caches: one level over 1,000,448 x 28 bins took 0.685 s in one call,
#: 0.584 / 0.335 / 0.280 / 0.311 s in chunks of 102,400 / 32,768 / 8,192
#: / 2,048 rows on an H100 machine's host (``chip_smoke.py`` phase 13)
HIST_CHUNK_ROWS = 8192


def hist_update(hg: np.ndarray, hh: np.ndarray, bins: np.ndarray,
                node_of: np.ndarray, g: np.ndarray, h: np.ndarray) -> None:
    """Accumulate one row slice into the level's float64 histograms.

    hg / hh [n_nodes, F, num_bins + 1] float64 (in place); bins [rows, F]
    integer; node_of [rows] dense positions; g / h [rows] float32.
    ``np.add.at`` adds in element order (row-major here), so consecutive
    row slices in order equal one whole-array call bit for bit; the rows
    go through it ``HIST_CHUNK_ROWS`` at a time.  Rows with g == h == 0
    (page padding) add +0.0, which changes no accumulator (none can hold
    -0.0)."""
    n_nodes, F, bp1 = hg.shape
    first = n_nodes - 1
    f_ix = np.arange(F, dtype=np.int64)[None, :]
    for lo in range(0, node_of.shape[0], HIST_CHUNK_ROWS):
        hi = lo + HIST_CHUNK_ROWS
        local = np.clip(node_of[lo:hi].astype(np.int64) - first, 0,
                        n_nodes - 1)
        seg = ((local[:, None] * F + f_ix) * bp1
               + bins[lo:hi].astype(np.int64)).reshape(-1)
        np.add.at(hg.reshape(-1), seg,
                  np.repeat(g[lo:hi].astype(np.float64), F))
        np.add.at(hh.reshape(-1), seg,
                  np.repeat(h[lo:hi].astype(np.float64), F))


def _segment_sum64(values: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    """Float64 sequential-order segment sum (``np.add.at``)."""
    acc = np.zeros((n,), np.float64)
    np.add.at(acc, seg.astype(np.int64), values.astype(np.float64))
    return acc


def _split_from_hist(hg64: np.ndarray, hh64: np.ndarray, feat_mask: np.ndarray,
                     *, num_bins: int, reg_lambda: float,
                     min_child_weight: float, min_split_gain: float):
    """Depth-wise split search over one level's histograms (host).

    Returns per node (feature, split_bin, default_left, terminal, node_g,
    node_h); a terminal node records feature 0 and passes rows through."""
    hg = hg64.astype(np.float32)
    hh = hh64.astype(np.float32)
    n_nodes, F, _ = hg.shape
    B = num_bins
    g_miss, h_miss = hg[..., B], hh[..., B]                # [n, F]
    cg = np.cumsum(hg[..., :B], axis=-1)                   # [n, F, B]
    ch = np.cumsum(hh[..., :B], axis=-1)
    g_tot = cg[..., -1] + g_miss
    h_tot = ch[..., -1] + h_miss

    lam = np.float32(reg_lambda)

    def score(G, H):
        return np.square(G) / (H + lam)

    # split at s (left = bins <= s), s in [0, B-2]; two missing dirs
    s_cg, s_ch = cg[..., : B - 1], ch[..., : B - 1]        # [n, F, B-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        parent = score(g_tot, h_tot)[..., None]            # [n, F, 1]
        gains = []
        for mdir in (0, 1):  # 0: missing right, 1: missing left
            GL = s_cg + (g_miss[..., None] if mdir else 0.0)
            HL = s_ch + (h_miss[..., None] if mdir else 0.0)
            GR = g_tot[..., None] - GL
            HR = h_tot[..., None] - HL
            gain = score(GL, HL) + score(GR, HR) - parent
            ok = (HL >= min_child_weight) & (HR >= min_child_weight)
            gains.append(np.where(ok, gain, -np.inf))
    gain_all = np.stack(gains, axis=-1)                    # [n, F, B-1, 2]
    gain_all = np.where(feat_mask[None, :, None, None], gain_all, -np.inf)

    flat = gain_all.reshape(n_nodes, -1)
    best = np.argmax(flat, axis=-1)                        # [n]
    best_gain = np.take_along_axis(flat, best[:, None], axis=-1)[:, 0]
    n_dirs = 2
    n_splits = (B - 1) * n_dirs
    feat = (best // n_splits).astype(np.int32)
    rem = best % n_splits
    split_bin = (rem // n_dirs).astype(np.int32)
    default_left = (rem % n_dirs) == 1

    with np.errstate(invalid="ignore"):
        terminal = ~(best_gain > min_split_gain)           # includes -inf/NaN
    feat = np.where(terminal, np.int32(0), feat)

    # every feature column partitions a node's rows, so feature 0 summed
    # over its bins is the node total (float64, one np.sum)
    node_g = hg64[:, 0, :].sum(axis=-1).astype(np.float32)
    node_h = hh64[:, 0, :].sum(axis=-1).astype(np.float32)
    return feat, split_bin, default_left, terminal, node_g, node_h


def _leaf_value_np(G: np.ndarray, H: np.ndarray, *, model_type: str,
                   learning_rate: float, reg_lambda: float) -> np.ndarray:
    if model_type == "randomforest":
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(H > 0, G / np.maximum(H, np.float32(1e-12)),
                            np.float32(0.0)).astype(np.float32)
    return (np.float32(-learning_rate) * G
            / (H + np.float32(reg_lambda))).astype(np.float32)


def _fma_f32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a * b + c with one rounding to float32 (nearest, ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    best = r
    for cand in (np.nextafter(r, np.float32(-np.inf)),
                 np.nextafter(r, np.float32(np.inf))):
        if not np.isfinite(cand):
            continue
        d, db = abs(Fraction(float(cand)) - exact), \
            abs(Fraction(float(best)) - exact)
        if d < db or (d == db and int(cand.view(np.uint32)) % 2 == 0):
            best = cand
    return np.float32(best)


def _quantile_f32(a: np.ndarray, q: float) -> np.float32:
    """``jnp.quantile(a, q)`` of a 1-D float32 array without NaN: the
    linear method in float32 (``jax/_src/numpy/reductions.py``
    ``_quantile``), whose final ``low * lw + high * hw`` XLA's CPU backend
    contracts to ``fma(high, hw, low * lw)``."""
    s = np.sort(a)
    n = np.float32(s.shape[0])
    pos = np.float32(q) * (n - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1.0) - hw)
    lo_i = int(min(max(low, np.float32(0.0)), n - np.float32(1.0)))
    hi_i = int(min(max(high, np.float32(0.0)), n - np.float32(1.0)))
    return _fma_f32(s[hi_i], hw, np.float32(s[lo_i] * lw))


def _tree_gradients(margin: np.ndarray, y: np.ndarray, cfg: TrainConfig,
                    tree_index: int, k_bag: np.ndarray, k_goss: np.ndarray):
    """Per-tree (g, h) over the REAL rows, host float32 arrays: one
    function for the resident and the streamed grower."""
    N = margin.shape[0]
    if cfg.model_type == "randomforest":
        w = prng.poisson(k_bag, 1.0, N).astype(np.float32)
        return y * w, w
    if cfg.task == "classification":
        p = torch.sigmoid(torch.from_numpy(margin)).numpy()
        g, h = p - y, p * (np.float32(1.0) - p)
    else:
        g, h = margin - y, np.ones((N,), np.float32)
    if cfg.model_type == "lightgbm" and tree_index > 0:
        # the first tree sees all rows (the LightGBM GOSS convention)
        a, b = cfg.goss_top, cfg.goss_rest
        ag = np.abs(g)
        thr = _quantile_f32(ag, 1.0 - a)
        top = ag >= thr
        rest = (~top) & (prng.uniform(k_goss, N) < np.float32(b))
        w = (top.astype(np.float32)
             + rest.astype(np.float32) * np.float32((1 - a) / b))
        g, h = g * w, h * w
    return g, h


def _tree_feature_mask(k_feat: np.ndarray, F: int,
                       cfg: TrainConfig) -> np.ndarray:
    if cfg.model_type == "randomforest" and cfg.colsample < 1.0:
        k_sel = max(1, int(round(cfg.colsample * F)))
        mask = np.zeros((F,), bool)
        mask[prng.permutation(k_feat, F)[:k_sel]] = True
        return mask
    return np.ones((F,), bool)


# ---------------------------------------------------------------------------
# The grower: drives run_scan over the binned relation, level by level
# ---------------------------------------------------------------------------


def grow_forest_scanned(run_scan, *, y: np.ndarray, num_rows: int,
                        num_features: int, total_rows: int | None = None,
                        edges: np.ndarray, cfg: TrainConfig,
                        device=None) -> Forest:
    """Grow a forest by scanning the binned relation once per level.

    ``run_scan(node_of, route=None, hist=None)`` visits every row of the
    binned relation in global row order: with ``route = (level, feat,
    sbin, dleft, term)`` it routes each row through :func:`route_level`
    (returning the new node_of), then with ``hist = (g, h, level)`` it
    accumulates that level's histograms through :func:`hist_update`,
    returning ``(node_of, (hg64, hh64) or None)``.

    ``total_rows`` is the relation's length with its page padding (those
    rows carry g = h = 0); ``num_rows`` the real rows that gradients and
    margins cover.  The forest is made on ``device`` (the card when
    None)."""
    if cfg.model_type not in ("randomforest", "xgboost", "lightgbm"):
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    N = int(num_rows)
    F = int(num_features)
    total = N if total_rows is None else int(total_rows)
    if total < N:
        raise ValueError(f"total_rows {total} < num_rows {N}")
    edges = np.asarray(edges, np.float32)
    y_np = np.asarray(y, np.float32)
    I, L = num_internal(cfg.max_depth), num_leaves(cfg.max_depth)

    key = prng.prng_key(cfg.seed)
    is_rf = cfg.model_type == "randomforest"
    reg_lambda = 0.0 if is_rf else cfg.reg_lambda
    lr = 1.0 if is_rf else cfg.learning_rate

    feature_T = np.zeros((cfg.num_trees, I), np.int32)
    threshold_T = np.full((cfg.num_trees, I), np.inf, np.float32)
    default_left_T = np.ones((cfg.num_trees, I), bool)
    node_is_leaf_T = np.zeros((cfg.num_trees, I), bool)
    node_value_T = np.zeros((cfg.num_trees, I), np.float32)
    leaf_value_T = np.zeros((cfg.num_trees, L), np.float32)

    margin = np.zeros((N,), np.float32)

    for t in range(cfg.num_trees):
        key, k_bag, k_feat, k_goss = prng.split(key, 4)
        g, h = _tree_gradients(margin, y_np, cfg, t, k_bag, k_goss)
        if total > N:  # page padding: inert rows
            g = np.concatenate([g, np.zeros((total - N,), np.float32)])
            h = np.concatenate([h, np.zeros((total - N,), np.float32)])
        feat_mask = _tree_feature_mask(k_feat, F, cfg)

        node_of = np.zeros((total,), np.int32)
        route = None
        for level in range(cfg.max_depth):
            node_of, hists = run_scan(node_of, route=route,
                                      hist=(g, h, level))
            feat, sbin, dleft, term, ng, nh = _split_from_hist(
                hists[0], hists[1], feat_mask,
                num_bins=cfg.num_bins, reg_lambda=reg_lambda,
                min_child_weight=cfg.min_child_weight,
                min_split_gain=cfg.min_split_gain)
            first = (1 << level) - 1
            sl = slice(first, first + (1 << level))
            feature_T[t, sl] = feat
            # threshold in feature units: left iff bin <= s iff
            # x < edges[f, s]; terminal -> pass-through (+inf, left)
            thr = edges[feat, np.clip(sbin, 0, cfg.num_bins - 2)]
            threshold_T[t, sl] = np.where(term, np.float32(np.inf), thr)
            default_left_T[t, sl] = np.where(term, True, dleft)
            node_is_leaf_T[t, sl] = term
            node_value_T[t, sl] = _leaf_value_np(
                ng, nh, model_type=cfg.model_type, learning_rate=lr,
                reg_lambda=reg_lambda)
            route = (level, feat, sbin, dleft, term)

        # the final scan routes through the last level to leaf positions
        node_of, _ = run_scan(node_of, route=route, hist=None)
        leaf_local = np.clip(node_of - I, 0, L - 1)
        leaf_g = _segment_sum64(g, leaf_local, L).astype(np.float32)
        leaf_h = _segment_sum64(h, leaf_local, L).astype(np.float32)
        lv = _leaf_value_np(leaf_g, leaf_h, model_type=cfg.model_type,
                            learning_rate=lr, reg_lambda=reg_lambda)
        leaf_value_T[t] = lv
        if not is_rf:
            # each row takes the value of the leaf it was fitted into
            margin = margin + lv[leaf_local[:N]]

    return make_forest(
        feature_T, threshold_T, leaf_value_T,
        default_left=default_left_T,
        node_is_leaf=node_is_leaf_T,
        node_value=node_value_T,
        n_features=F,
        model_type=cfg.model_type,
        task=cfg.task,
        base_score=0.0,
        device=device,
    )


# ---------------------------------------------------------------------------
# The resident trainer (the whole binned matrix at once)
# ---------------------------------------------------------------------------


def _resident_scan(bins: torch.Tensor, num_bins: int):
    """Scan provider over a resident [N, F] int32 binned matrix: routing
    on its device, histograms over its host copy."""
    bins_np = bins.cpu().numpy()

    def run_scan(node_of, *, route=None, hist=None):
        if route is not None:
            level, feat, sbin, dleft, term = route
            node_of = route_level(
                bins, torch.as_tensor(node_of, device=bins.device), feat,
                sbin, dleft, term, level=level,
                num_bins=num_bins).cpu().numpy()
        hists = None
        if hist is not None:
            g, h, level = hist
            n_nodes = 1 << level
            F = bins_np.shape[1]
            hg = np.zeros((n_nodes, F, num_bins + 1), np.float64)
            hh = np.zeros((n_nodes, F, num_bins + 1), np.float64)
            hist_update(hg, hh, bins_np, node_of, g, h)
            hists = (hg, hh)
        return node_of, hists

    return run_scan


def train_forest(x: np.ndarray, y: np.ndarray, cfg: TrainConfig, *,
                 edges: np.ndarray | None = None, device=None) -> Forest:
    """Train a forest on resident [N, F] features / [N] targets (host
    arrays).  Binning and routing run on ``device`` (the card when None),
    and the forest lands there.  ``edges`` overrides the exact-quantile
    binning: the streamed trainer's bit-identity holds given the same
    edges."""
    dev = resolve_device(device)
    x_np = np.asarray(x, np.float32)
    y_np = np.asarray(y, np.float32)
    N, F = x_np.shape
    if edges is None:
        edges = quantile_bin_edges(x_np, cfg.num_bins)
    bins = bin_features(torch.from_numpy(x_np).to(dev),
                        torch.from_numpy(np.asarray(edges, np.float32)))
    return grow_forest_scanned(
        _resident_scan(bins, cfg.num_bins),
        y=y_np, num_rows=N, num_features=F, edges=edges, cfg=cfg,
        device=dev)
