"""The device mesh, its host-bookkeeping part (counterpart of
paddle_tpu/distributed/mesh.py:25-230).

The coordinators (framework/coordination.py) call :func:`handle_host_loss`
on every host loss and :func:`absorb_hosts` on every rejoin: the global
mesh is rebuilt over the surviving fraction of the ``dp`` axis (scaled
from the axes :func:`init_mesh` was given, never compounded), a
``mesh_reinit`` or ``mesh_absorb`` event is recorded and the hooks of
:func:`add_reinit_hook` run with ``(lost, live, mesh)``, as in the JAX
package. On one card a mesh's sizes multiply to 1, so a resize changes
no mesh and :func:`reshard_state` moves nothing; a mesh whose sizes
multiply to more than 1 is refused by ``compiler.check_mesh`` (a
``ValueError`` when it needs more devices than there are,
``NotPortedError`` otherwise): multi-device meshes, sharding
annotations and a real reshard arrive with the torch.distributed slice.
"""
from ..framework import resilience
from ..framework.compiler import check_mesh, visible_devices

_mesh = None
_mesh_axes = None      # last init_mesh axes: what a re-init rebuilds from
_reinit_hooks = []     # fns(lost_hosts, live_hosts, mesh) run after re-init
_lost_hosts = set()    # hosts currently out of the mesh (cumulative)
_total_hosts = None    # pod size the loss/absorb fractions scale against


class Mesh(object):
    """A named-axis device mesh: ``shape`` {axis: size} in order,
    ``axis_names`` and ``devices`` (how many devices it spans)."""

    def __init__(self, mesh_axes, devices=1):
        self.shape = dict(mesh_axes)
        self.axis_names = tuple(self.shape)
        self.devices = int(devices)

    def __eq__(self, other):
        return isinstance(other, Mesh) and \
            list(self.shape.items()) == list(other.shape.items())

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(tuple(self.shape.items()))

    def __repr__(self):
        return "Mesh(%r)" % (self.shape,)


class DistributedStrategy(object):
    """fleet's DistributedStrategy: the knobs that map onto mesh and
    sharding decisions."""

    def __init__(self):
        self.mesh_axes = {"dp": 1}
        self.amp = False
        self.recompute = False
        self.gradient_merge_steps = 1
        self.sharding_optimizer_state = False  # ZeRO-1 style
        self.collective_timeout_s = 600.0
        self.pipeline = False
        self.pp_schedule = "1f1b"      # "1f1b" | "gpipe"
        self.pp_num_micro = 1


def init_mesh(mesh_axes=None, devices=None, multihost=False):
    """Create and install the global mesh, e.g. ``{"dp": 1}`` (the
    default: one axis over the visible devices). ``multihost`` has
    nothing to enroll on one card."""
    global _mesh, _mesh_axes
    n_dev = len(devices) if devices is not None else visible_devices()
    mesh_axes = dict(mesh_axes or {"dp": n_dev})
    check_mesh(mesh_axes, n_dev)
    _mesh = Mesh(mesh_axes)
    _mesh_axes = dict(mesh_axes)
    return _mesh


def reset_mesh():
    """Uninstall the global mesh (tests, reconfiguration)."""
    global _mesh, _mesh_axes, _total_hosts
    _mesh = None
    _mesh_axes = None
    _lost_hosts.clear()
    _total_hosts = None


def add_reinit_hook(fn):
    """Register ``fn(lost_hosts, live_hosts, mesh)`` to run after the mesh
    is rebuilt on a host loss or rejoin. Returns fn."""
    _reinit_hooks.append(fn)
    return fn


def clear_reinit_hooks():
    del _reinit_hooks[:]


def _scaled(axes, n_live, total):
    """``axes`` with ``dp`` scaled by the live fraction."""
    axes = dict(axes)
    if n_live < total and total and "dp" in axes and axes["dp"] > 1:
        axes["dp"] = max(1, axes["dp"] * n_live // total)
    return axes


def _rebuild(n_live, total):
    global _mesh
    if _mesh is not None and _mesh_axes:
        _mesh = Mesh(_scaled(_mesh_axes, n_live, total))


def handle_host_loss(lost_hosts, live_hosts):
    """Coordinator host-loss hook: rebuild the global mesh over the
    survivors (``dp`` scaled by the live fraction of the original axes:
    ``lost_hosts`` is cumulative) and run the reinit hooks. Returns the
    new mesh (None when none is installed)."""
    global _total_hosts
    lost, live = sorted(lost_hosts), sorted(live_hosts)
    _lost_hosts.clear()
    _lost_hosts.update(lost)
    _total_hosts = len(lost) + len(live)
    resilience.record_event("mesh_reinit", lost=lost, live=live)
    _rebuild(len(live), _total_hosts)
    for fn in list(_reinit_hooks):
        fn(lost, live, _mesh)
    return _mesh


def absorb_hosts(joined, live_hosts):
    """Inverse of :func:`handle_host_loss`: ``joined`` hosts are back
    (``live_hosts`` includes them); the mesh re-grows from the original
    axes by the new live fraction (all back: the full mesh again) and
    the same hooks run. Returns the new mesh (None when none is
    installed)."""
    global _total_hosts
    joined, live = sorted(joined), sorted(live_hosts)
    _lost_hosts.difference_update(joined)
    if _total_hosts is None:
        _total_hosts = len(_lost_hosts) + len(live)
    total = _total_hosts
    resilience.record_event("mesh_absorb", joined=joined, live=live,
                            capacity="%d/%d" % (len(live), total))
    _rebuild(len(live) if _lost_hosts else total, total)
    for fn in list(_reinit_hooks):
        fn(sorted(_lost_hosts), live, _mesh)
    return _mesh


def reshard_state(state, old_mesh, new_mesh):
    """``state`` ({name: value}) placed for ``new_mesh``: a new dict. On
    one card both meshes span one device, so every value stays where it
    is; a ``reshard`` event records the move (``moved`` 0), as the JAX
    package's does."""
    for m in (old_mesh, new_mesh):
        if m is not None:
            check_mesh(m.shape, max(1, m.devices))
    resilience.record_event(
        "reshard", moved=0, gathered=0,
        old=None if old_mesh is None else
        {a: int(s) for a, s in old_mesh.shape.items()},
        new={a: int(s) for a, s in new_mesh.shape.items()})
    return dict(state)


def get_mesh():
    return _mesh


def mesh_axes():
    return tuple(_mesh.axis_names) if _mesh is not None else ()


__all__ = ["Mesh", "DistributedStrategy", "init_mesh", "reset_mesh",
           "get_mesh", "mesh_axes", "add_reinit_hook",
           "clear_reinit_hooks", "handle_host_loss", "absorb_hosts",
           "reshard_state"]
