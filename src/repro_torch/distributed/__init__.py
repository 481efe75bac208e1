"""Distributed layer of the port: the mesh rules and placements over a
``DeviceMesh`` (``sharding``), the int8 pod hop with error feedback and
its train step (``compression``), and cluster resize planning
(``elastic``)."""
