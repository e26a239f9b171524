"""Launch-side helpers of the port (mirrors ``repro/launch/``): so far the
calibration half of ``roofline.py``, the peaks table the cost-based
optimizer ranks its cells with."""
