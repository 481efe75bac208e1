"""Distributed layer of the port: the mesh rules the device pushdown
reads (``sharding``) and cluster resize planning (``elastic``)."""
