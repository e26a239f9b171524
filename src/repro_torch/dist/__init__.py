"""Device meshes of the port (mirrors ``repro/dist/``): the forest half of
``sharding.py``, the axis mapping and placement the query plans run their
data- and model-parallel stages under, and ``compression.py``, the int8
gradient compression with error feedback."""
