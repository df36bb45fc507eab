"""The port's op registry against the JAX package's: every op type of
paddle_tpu is ported but the deferred ones named here, each tagged with
the slice that brings it (ROADMAP.md, Queue 1, lists the same). The
test fails when either side drifts: an op type the JAX package gains,
one the port adds or drops, or a deferred one ported without leaving
this list.
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
    "the detection ops (detection_ops, detection_train_ops)": [
        "anchor_generator", "bipartite_match", "box_clip", "box_coder",
        "box_decoder_and_assign", "collect_fpn_proposals",
        "density_prior_box", "distribute_fpn_proposals",
        "generate_proposals", "iou_similarity", "mine_hard_examples",
        "polygon_box_transform", "prior_box", "roi_align", "roi_pool",
        "sigmoid_focal_loss", "ssd_loss", "target_assign",
        "generate_mask_labels", "generate_proposal_labels",
        "locality_aware_nms", "retinanet_detection_output",
        "retinanet_target_assign", "roi_perspective_transform",
        "rpn_target_assign"],
    "the text-matching contrib (contrib_ops)": [
        "match_matrix_tensor", "sequence_topk_avg_pooling",
        "shuffle_batch", "var_conv_2d"],
    "contrib/slim (quant_ops' fake-quant ops)": [
        "fake_channel_wise_quantize_dequantize_abs_max",
        "fake_quantize_dequantize_abs_max",
        "fake_quantize_dequantize_moving_average_abs_max"],
}


def _deferred():
    return [op for ops in DEFERRED.values() for op in ops]


def test_deferred_list_is_43_distinct_op_types():
    ops = _deferred()
    assert len(ops) == len(set(ops)) == 43


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
    assert len(port_ops) == 258 and len(jax_ops) == 301
