"""Host syncs per decoded block over the window: the change of the beam
loops' ``BlockLoop.syncs`` over the change of their ``BlockLoop.blocks``
(one sync per replay of the step graph, so one per beam step)."""


def read(rec):
    blocks = len(rec["blocks"])
    if not blocks:
        return None
    return sum(b["syncs"] for b in rec["blocks"]) / blocks
