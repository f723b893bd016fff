"""graph_nodes_per_block (nodes): the nodes of the continuing chain graph
a stream cell replays, over the blocks it chains (its depth), as the
program records them at capture (``program_spans.continuing_chain``): the
captured work a block, kernels, copies and sets. Nothing where no graph
was captured (the loop of steps on the CPU)."""

from rtbench import program_spans as ps


def read(view):
    if view.kind != "stream":
        return None
    chain = ps.continuing_chain()
    if chain is None:
        return None
    return chain["nodes"] / chain["depth"]
