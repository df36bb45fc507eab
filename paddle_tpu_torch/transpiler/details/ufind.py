"""Union-find (counterpart of paddle_tpu/transpiler/details/ufind.py; ref
transpiler/details/ufind.py): used by the reference
transpiler to group variables that must co-locate; generally useful for
partition planning."""

__all__ = ["UnionFind"]


class UnionFind(object):
    """Union-find over an initial element list; elements hashable."""

    def __init__(self, elements=None):
        self._parent = {}
        for e in elements or ():
            self._parent.setdefault(e, e)

    def _root(self, x):
        self._parent.setdefault(x, x)
        while self._parent[x] != x:
            self._parent[x] = self._parent[self._parent[x]]
            x = self._parent[x]
        return x

    def union(self, a, b):
        ra, rb = self._root(a), self._root(b)
        if ra != rb:
            self._parent[rb] = ra

    def is_connected(self, a, b):
        return self._root(a) == self._root(b)

    def find(self, x):
        return self._root(x)
