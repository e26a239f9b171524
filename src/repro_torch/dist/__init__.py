"""Device meshes of the port (mirrors ``repro/dist/``): the forest half of
``sharding.py``, the axis mapping and placement the query plans run their
data- and model-parallel stages under, ``compression.py``, the int8
gradient compression with error feedback, and ``collectives.py``, the
record of the collectives a mesh would run where the port's code would
run them."""
