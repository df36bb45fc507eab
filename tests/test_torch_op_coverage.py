"""The port's op registry against the JAX package's: every op type of
paddle_tpu is ported but the deferred ones named here (11: the
collectives), each tagged with the slice that brings it (ROADMAP.md,
Queue 1, lists the same). The port has 290 of the JAX package's 301.
The test fails when either side drifts: an op type the JAX package
gains, one the port adds or drops, or a deferred one ported without
leaving this list.
"""
import paddle_tpu.ops  # noqa: F401  (registers the JAX kernels)
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg

DEFERRED = {
    "multi-GPU over torch.distributed (collective_ops)": [
        "barrier", "c_allgather", "c_allreduce_max", "c_allreduce_min",
        "c_allreduce_prod", "c_allreduce_sum", "c_allreduce_sum_quant",
        "c_broadcast", "c_reducescatter", "c_sync_comm_stream", "ppermute"],
}


def _deferred():
    return [op for ops in DEFERRED.values() for op in ops]


def test_deferred_list_is_11_distinct_op_types():
    """The deferred list's length: the 11 collectives, since the slim
    fake-quant ops were ported."""
    ops = _deferred()
    assert len(ops) == len(set(ops)) == 11


def test_port_registry_is_the_jax_registry_minus_the_deferred():
    jax_ops = set(jreg._REGISTRY)
    port_ops = set(treg._REGISTRY)
    deferred = set(_deferred())
    assert deferred <= jax_ops, sorted(deferred - jax_ops)
    assert not deferred & port_ops, sorted(deferred & port_ops)
    assert port_ops == jax_ops - deferred, (
        "ported but not in the JAX package: %s; in the JAX package, "
        "neither ported nor deferred: %s"
        % (sorted(port_ops - jax_ops), sorted(jax_ops - deferred - port_ops)))
    assert len(port_ops) == 290 and len(jax_ops) == 301
