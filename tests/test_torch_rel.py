"""Port parity: the relation-centric plans, ``infer(plan="rel" |
"rel+reuse")``, end to end.

The same stored rows (with NaN rows and page padding) and the same forest
go through the reference ``ForestQueryEngine.infer`` (Pallas kernels in
interpret mode) and the port's, on the CPU device, for every kernel
algorithm (fused and raw) and the plain ``predicated`` oracle, at an
explicit partition count.  Bit-identical on small-integer leaves of a
regression forest (every sum is exact, phase 2 too); within 1e-6
otherwise, since ``torch.sum``, ``jnp.sum`` and the reference's per-tile
fused sums add in other orders.  Stage names, stage counts and cache hits
must be the reference's.
"""

import numpy as np
import pytest

from repro.core.reuse import ModelReuseCache as JCache
from repro.db.query import ForestQueryEngine as JEngine
from repro.db.store import TensorBlockStore as JStore
from repro_torch.core.reuse import ModelReuseCache
from repro_torch.db.query import ForestQueryEngine
from repro_torch.db.store import TensorBlockStore

from test_torch_forest import port_forest
from test_torch_query import PAGE, _forest, _rows

ALGORITHMS = ["predicated_pallas_fused", "hummingbird_pallas_fused",
              "quickscorer_pallas_fused", "predicated_pallas",
              "hummingbird_pallas", "quickscorer_pallas", "predicated"]
STAGES = ["stageP:model-partition", "stage0:cross-product:partial-agg",
          "stage1:aggregate", "stage2:write"]


@pytest.mark.parametrize("integer_leaves", [False, True],
                         ids=["float", "integer"])
@pytest.mark.parametrize("n_parts", [1, 3])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("plan", ["rel", "rel+reuse"])
def test_rel_infer_matches_reference(plan, algorithm, n_parts,
                                     integer_leaves):
    x = _rows(6)
    jf = _forest(integer_leaves=integer_leaves)
    jstore = JStore(default_page_rows=PAGE)
    jstore.put("t", x)
    jengine = JEngine(jstore, reuse_cache=JCache(), plan_cache=JCache())
    store = TensorBlockStore(device="cpu", default_page_rows=PAGE)
    store.put("t", x)
    engine = ForestQueryEngine(store, reuse_cache=ModelReuseCache(),
                               plan_cache=ModelReuseCache())
    tf = port_forest(jf)
    kw = dict(algorithm=algorithm, plan=plan, n_parts=n_parts)
    wants = [jengine.infer("t", jf, **kw) for _ in range(2)]
    gots = [engine.infer("t", tf, **kw) for _ in range(2)]
    for want, got in zip(wants, gots):
        w, g = np.asarray(want.predictions), got.predictions.numpy()
        assert g.shape == (x.shape[0],) and np.isfinite(g).all()
        if integer_leaves:
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        assert got.num_stages == want.num_stages == 4
        assert [r.name for r in got.stage_reports] == \
            [r.name for r in want.stage_reports] == STAGES
        assert got.n_parts == want.n_parts == n_parts
        assert (got.reuse_hit, got.plan_reuse_hit) == \
            (want.reuse_hit, want.plan_reuse_hit)
    first, second = gots
    assert not first.reuse_hit and first.partition_s > 0
    if plan == "rel+reuse":
        assert second.reuse_hit and second.plan_reuse_hit
        assert second.partition_s == 0.0
    else:                               # the uncached baseline
        assert not second.reuse_hit and second.partition_s > 0
        assert len(engine.cache) == len(engine.plan_cache) == 0
