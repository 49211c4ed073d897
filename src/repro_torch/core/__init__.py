"""P2P swarm-learning core of the port: flat layout, topology, merge
strategies, the stacked engine and the :class:`SwarmSession` entry point
(``repro_torch.core.session``)."""
