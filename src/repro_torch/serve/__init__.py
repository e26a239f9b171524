"""The forest serving plane (``forest.py``) and its router (``router.py``)."""
