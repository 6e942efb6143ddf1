"""Multi-stream tracking: S sequences on a stream axis (multistream.py)
and the stream-to-device map (mesh.py)."""
