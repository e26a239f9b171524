"""Launch-side helpers of the port (mirrors ``repro/launch/``):
``roofline.py`` (the calibrated peaks the cost-based optimizer ranks its
cells with, the roofline terms, model FLOPs); ``mesh.py``'s meshes and
``H100`` table; ``serve.py`` and ``train.py``, the LM serving and training
CLIs; and the dry-run: ``hlo_cost.py`` (the op-level cost counter),
``dryrun.py`` and ``hillclimb.py``."""
