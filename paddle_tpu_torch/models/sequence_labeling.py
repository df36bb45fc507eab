"""BiGRU-CRF sequence labeling (counterpart of
paddle_tpu/models/sequence_labeling.py; reference: PaddlePaddle/models
LAC, lexical analysis, and the fluid label_semantic_roles chapter).

Embedding -> stacked bidirectional GRU -> per-token emissions ->
linear_chain_crf training loss, crf_decoding for inference: the
NER/POS/LAC architecture, on dense (N, T) batches with length vectors.
"""
import numpy as np

from .. import layers
from ..contrib.layers import basic_gru
from ..framework import analysis
from ..framework.program import Program, program_guard
from ..param_attr import ParamAttr

__all__ = ["bigru_crf_program", "synthetic_tagging_batch"]


def bigru_crf_program(vocab_size=1000, num_labels=9, emb_dim=64,
                      hidden=64, num_layers=1, seq_len=32,
                      optimizer_fn=None, crf_lr=1.0):
    """(main, startup, feeds, fetches): fetches carry 'loss' (mean
    negative CRF log-likelihood) and 'decode' (Viterbi paths).

    ``crf_lr`` does not reach the optimizer, in the JAX package as here:
    crf_decoding creates ``crfw`` again with a plain ParamAttr, and the
    second creation's learning rate (1.0) is the one the program keeps
    (ROADMAP, carried from the reference on purpose)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        words = layers.data("words", [seq_len], "int64")
        targets = layers.data("targets", [seq_len], "int64")
        lens = layers.data("lens", [1], "int64")
        length = layers.reshape(lens, [-1])
        emb = layers.embedding(words, size=[vocab_size, emb_dim])
        rnn_out, _ = basic_gru(emb, None, hidden_size=hidden,
                               num_layers=num_layers, bidirectional=True,
                               sequence_length=length)
        emission = layers.fc(rnn_out, size=num_labels, num_flatten_dims=2)
        crf_attr = ParamAttr(name="crfw", learning_rate=crf_lr)
        ll = layers.linear_chain_crf(emission, targets,
                                     param_attr=crf_attr, length=length)
        loss = layers.reduce_mean(layers.scale(ll, scale=-1.0))
        decode = layers.crf_decoding(emission,
                                     param_attr=ParamAttr(name="crfw"),
                                     length=length)
        if optimizer_fn is not None:
            optimizer_fn(loss)
    # dce allowlist (the JAX package's): basic_gru always emits its
    # last-state gather chain (a one_hot-over-time matmul per direction
    # and the final stack), but this head reads only the per-step
    # emissions; the chain is dead by the API's shape and the report
    # would flag it at every compile
    analysis.allowlist(main, analysis.PASS_DCE,
                       reason="rnn last-state chain unused by the "
                              "CRF head")
    return main, startup, \
        {"words": words, "targets": targets, "lens": lens}, \
        {"loss": loss, "decode": decode}


def synthetic_tagging_batch(batch, seq_len=32, vocab_size=1000,
                            num_labels=9, seed=0):
    """Deterministic word -> label structure (label = word bucket), so the
    tagger can fit the mapping in a short run; the JAX package's draws
    from the same seed."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, vocab_size, (batch, seq_len)).astype(np.int64)
    targets = (words % num_labels).astype(np.int64)
    lens = rng.randint(seq_len // 2, seq_len + 1,
                       (batch, 1)).astype(np.int64)
    return {"words": words, "targets": targets, "lens": lens}
