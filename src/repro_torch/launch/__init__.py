"""Launchers of the port: token and semantic serving, training, the
query server, and the mesh builders (``mesh``)."""
