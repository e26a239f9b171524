"""The forest serving plane (``forest.py``), its router (``router.py``)
and the LM serving engine (``engine.py``)."""
