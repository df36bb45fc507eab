"""Sequence layers (counterpart of paddle_tpu/layers/sequence_lod.py):
only ``sequence_reverse`` so far, which the bidirectional RNNs of
``contrib.layers.basic_gru`` use."""
from ..layer_helper import LayerHelper
from ..ops.registry import NotPortedError


def sequence_reverse(x, lengths=None, name=None):
    """Reverse each valid prefix (reference sequence_reverse_op); the
    padding stays in place."""
    if lengths is None:
        raise NotPortedError(
            "sequence_reverse without lengths arrives with the sequence-op "
            "slice of paddle_tpu_torch; layers.reverse flips a whole axis")
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("sequence_reverse",
                     inputs={"X": [x.name], "Length": [lengths.name]},
                     outputs={"Y": [out.name]})
    return out


__all__ = ["sequence_reverse"]
