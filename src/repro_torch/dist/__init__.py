"""Device meshes of the port (mirrors ``repro/dist/``): so far the forest
half of ``sharding.py``, the axis mapping and placement the query plans
run their data- and model-parallel stages under."""
