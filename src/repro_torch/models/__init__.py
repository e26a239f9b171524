"""Model zoo of the port (mirrors ``repro/models/``): so far the dense
decoder-only LM (``layers.py``' dense half, ``lm.py``, ``registry.py``)."""

from repro_torch.models.registry import ModelBundle, get_bundle  # noqa: F401
