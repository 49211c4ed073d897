"""The reference of a cell's commit, one module a kind, named by the
cell's ``sync_reference`` (``reference/sync/<name>.py``). Each has:

``refuse(swarm)``
    why it cannot compute the sync that ``swarm`` (the cell's ``swarm``
    block) states, or None; a run refuses such a cell at set-up.
``candidate(stacked, node, swarm, data_sizes, store, device, policy)``
    node ``node``'s merged candidate from every node's params ``stacked``
    (``{path: [N, ...]}``), as the sync would commit it if its gate
    accepts.
"""
