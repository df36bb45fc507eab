"""Distributed-variable descriptors (counterpart of paddle_tpu/
transpiler/details/vars_distributed.py; ref transpiler/details/
vars_distributed.py): bookkeeping for how one logical variable is split
into per-shard blocks. A mesh shards by each var's sharding annotation, so
these descriptors serve porting/introspection of transpiler-era plans.
"""

__all__ = ["VarStruct", "VarDistributed", "VarsDistributed"]


class VarStruct(object):
    """Static description of one variable (name/shape/dtype/lod/persist)."""

    def __init__(self, name, shape, dtype, type=None, lod_level=0,
                 persistable=False):
        self.name = name
        self.shape = tuple(shape or ())
        self.dtype = dtype
        self.type = type
        self.lod_level = lod_level
        self.persistable = persistable

    def __repr__(self):
        return "VarStruct(%s, shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)


class VarDistributed(object):
    """One shard of an origin variable: its slice geometry + placement."""

    def __init__(self, origin_var, slice_var, is_slice=None, block_id=None,
                 offset=None, vtype=None, endpoint=None):
        self.origin_var = origin_var
        self.slice_var = slice_var
        self.is_slice = bool(is_slice)
        self.block_id = block_id
        self.offset = offset
        self.vtype = vtype
        self.endpoint = endpoint

    @staticmethod
    def equal(var1, var2):
        return (var1.name == var2.name and var1.shape == var2.shape
                and str(var1.dtype) == str(var2.dtype)
                and var1.lod_level == var2.lod_level
                and var1.persistable == var2.persistable)

    def __repr__(self):
        return "VarDistributed(%s -> %s @%s)" % (
            getattr(self.origin_var, "name", self.origin_var),
            getattr(self.slice_var, "name", self.slice_var),
            self.endpoint)


class VarsDistributed(object):
    """Registry of VarDistributed entries keyed by slice-var name."""

    def __init__(self):
        self.distributed_vars = {}

    def add_distributed_var(self, origin_var, slice_var, is_slice=None,
                            block_id=None, offset=None, vtype=None,
                            endpoint=None):
        v = VarDistributed(origin_var, slice_var, is_slice, block_id,
                           offset, vtype, endpoint)
        self.distributed_vars[getattr(slice_var, "name", slice_var)] = v
        return v

    def get_distributed_var_by_slice(self, name):
        return self.distributed_vars.get(name)

    def get_distributed_var_by_origin_and_ep(self, origin_name, endpoint):
        for v in self.distributed_vars.values():
            if getattr(v.origin_var, "name", v.origin_var) == origin_name \
                    and v.endpoint == endpoint:
                return v
        return None
