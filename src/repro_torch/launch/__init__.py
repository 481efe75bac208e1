"""Launchers of the port (``serve``, ``train``) and mesh construction
(``mesh``)."""
