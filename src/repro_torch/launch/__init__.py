"""Launch-side helpers of the port (mirrors ``repro/launch/``): the
calibration half of ``roofline.py``, the peaks table the cost-based
optimizer ranks its cells with; ``mesh.py``'s ``make_local_mesh``;
``serve.py``, the LM serving CLI; and ``train.py``, the LM training CLI."""
