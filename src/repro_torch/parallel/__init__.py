"""Distribution layer of the LM half: sharding rules and placement, hints,
the GPipe pipeline and int8 gradient compression, on A5's single
controller (``launch/mesh.py``)."""
from . import compress, hints, pipeline, sharding
