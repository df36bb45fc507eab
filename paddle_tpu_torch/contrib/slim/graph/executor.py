"""SlimGraphExecutor (counterpart of paddle_tpu/contrib/slim/graph/
executor.py): run a GraphWrapper's Program through the Executor."""
import numpy as np

__all__ = ["SlimGraphExecutor"]


class SlimGraphExecutor(object):
    """``place``: the Executor's (None: CUDAPlace(0))."""

    def __init__(self, place=None):
        from ....framework.executor import Executor
        self.exe = Executor(place)
        self.place = place

    def run(self, graph, scope=None, data=None):
        """Run ``graph`` (a GraphWrapper or a Program) and return its
        out_nodes' values. ``data``: a feed dict, or rows of samples
        zipped onto the in_nodes' names."""
        program = getattr(graph, "program", graph)
        fetch_list = list(getattr(graph, "out_nodes", {}).values())
        feed = None
        if data is not None:
            in_nodes = getattr(graph, "in_nodes", {})
            if isinstance(data, dict):
                feed = data
            else:
                feed = {name: np.asarray(col) for name, col in
                        zip(in_nodes, map(list, zip(*data)))}
        return self.exe.run(program, feed=feed, scope=scope,
                            fetch_list=fetch_list)
