"""GPT-style causal language model (static graph): next-token
pretraining and greedy decode.

Counterpart of paddle_tpu/models/gpt.py: the same layers, op types, var
and parameter names, so the two packages' programs serialize the same and
a scope trained by either decodes in both. Pre-LN blocks; causal attention
through ``fused_attention`` (the flash-attention kernels on the card);
the tied-embedding head through ``fused_mlm_head_loss`` in training (the
fused-head kernels where they tile: no (tokens, vocab) logits) and a
``matmul`` against the embedding table in decode, where the logits are the
output. ``dtype="bfloat16"`` runs the blocks in bf16 (f32 embeddings,
LayerNorm parameters and logits); ``recompute=True`` makes each training
block a ``recompute_segment``. Tensor-parallel annotations (``tp``) and
sequence-parallel attention (``attn_impl="ring"/"ulysses"``) belong to
the multi-GPU slice and raise NotPortedError.
"""
import math

import numpy as np

from .. import layers
from ..framework.program import Program, program_guard
from ..initializer import TruncatedNormalInitializer
from ..layers.attention import fused_attention
from ..ops.registry import NotPortedError
from ..param_attr import ParamAttr


class GPTConfig(object):
    def __init__(self, vocab_size=32000, hidden_size=768, num_layers=12,
                 num_heads=12, ff_size=3072, max_position=2048,
                 dropout=0.1, initializer_range=0.02, dtype="float32",
                 attn_impl="auto", recompute=False, tp=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ff_size = ff_size
        self.max_position = max_position
        self.dropout = dropout
        self.initializer_range = initializer_range
        self.dtype = dtype
        self.attn_impl = attn_impl      # "auto" | "flash" | "xla"
        self.recompute = recompute
        self.tp = tp


def gpt_base(**kw):
    return GPTConfig(**kw)


def _refuse_unported(cfg):
    """NotPortedError, naming its slice, for a setting the port lacks."""
    if cfg.tp:
        raise NotPortedError(
            "GPTConfig(tp=True) shards the model over a tensor-parallel "
            "mesh; it arrives with the multi-GPU slice of paddle_tpu_torch")
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotPortedError(
            "GPTConfig(attn_impl=%r) is sequence-parallel attention over "
            "several cards; it arrives with the multi-GPU slice of "
            "paddle_tpu_torch" % (cfg.attn_impl,))


def _init(cfg):
    return TruncatedNormalInitializer(scale=cfg.initializer_range)


def _attr(cfg, name, sharding=None):
    return ParamAttr(name=name, initializer=_init(cfg),
                     sharding=sharding if cfg.tp else None)


def _split_heads(x, n_head, d_head):
    # (N, T, H*Dh) -> (N, H, T, Dh)
    x = layers.reshape(x, [0, 0, n_head, d_head])
    return layers.transpose(x, [0, 2, 1, 3])


def _merge_heads(x, d_model):
    x = layers.transpose(x, [0, 2, 1, 3])
    return layers.reshape(x, [0, 0, d_model])


def decoder_block(x, cfg, name, is_test=False):
    """Pre-LN causal transformer block."""
    d = cfg.hidden_size
    dh = d // cfg.num_heads

    ln1 = layers.layer_norm(x, begin_norm_axis=2,
                            param_attr=ParamAttr(name=name + "_ln1_s"),
                            bias_attr=ParamAttr(name=name + "_ln1_b"))
    qkv = layers.fc(ln1, 3 * d, num_flatten_dims=2,
                    param_attr=_attr(cfg, name + "_qkv.w_0", (None, "mp")),
                    bias_attr=ParamAttr(name=name + "_qkv.b_0"))
    q, k, v = layers.split(qkv, 3, dim=2)
    ctx = fused_attention(
        _split_heads(q, cfg.num_heads, dh),
        _split_heads(k, cfg.num_heads, dh),
        _split_heads(v, cfg.num_heads, dh),
        scale=1.0 / math.sqrt(dh), causal=True, impl=cfg.attn_impl)
    attn = layers.fc(_merge_heads(ctx, d), d, num_flatten_dims=2,
                     param_attr=_attr(cfg, name + "_proj.w_0",
                                      ("mp", None)),
                     bias_attr=ParamAttr(name=name + "_proj.b_0"))
    if cfg.dropout:
        attn = layers.dropout(attn, cfg.dropout, is_test=is_test,
                              dropout_implementation="upscale_in_train")
    x = layers.elementwise_add(x, attn)

    ln2 = layers.layer_norm(x, begin_norm_axis=2,
                            param_attr=ParamAttr(name=name + "_ln2_s"),
                            bias_attr=ParamAttr(name=name + "_ln2_b"))
    ff = layers.fc(ln2, cfg.ff_size, num_flatten_dims=2, act="gelu",
                   param_attr=_attr(cfg, name + "_ffn0.w_0",
                                    (None, "mp")),
                   bias_attr=ParamAttr(name=name + "_ffn0.b_0"))
    ff = layers.fc(ff, d, num_flatten_dims=2,
                   param_attr=_attr(cfg, name + "_ffn1.w_0",
                                    ("mp", None)),
                   bias_attr=ParamAttr(name=name + "_ffn1.b_0"))
    if cfg.dropout:
        ff = layers.dropout(ff, cfg.dropout, is_test=is_test,
                            dropout_implementation="upscale_in_train")
    return layers.elementwise_add(x, ff)


def gpt_decoder(token_ids, pos_ids, cfg, is_test=False):
    """Token+position embed -> N pre-LN blocks -> final LN.
    Returns (N, T, H) hidden states (cfg.dtype)."""
    _refuse_unported(cfg)
    emb = layers.embedding(
        token_ids, [cfg.vocab_size, cfg.hidden_size],
        param_attr=_attr(cfg, "gpt_word_embedding", ("mp", None)),
        dtype="float32")
    pos = layers.embedding(
        pos_ids, [cfg.max_position, cfg.hidden_size],
        param_attr=ParamAttr(name="gpt_pos_embedding",
                             initializer=_init(cfg)),
        dtype="float32")
    x = layers.elementwise_add(emb, pos)
    if cfg.dropout:
        x = layers.dropout(x, cfg.dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    if cfg.dtype == "bfloat16":
        x = layers.cast(x, "bfloat16")
    for i in range(cfg.num_layers):
        if cfg.recompute and not is_test:
            x = layers.recompute_segment(
                lambda h, i=i: decoder_block(h, cfg, "gpt_layer_%d" % i,
                                             is_test=is_test), [x])
        else:
            x = decoder_block(x, cfg, "gpt_layer_%d" % i, is_test=is_test)
    return layers.layer_norm(x, begin_norm_axis=2,
                             param_attr=ParamAttr(name="gpt_lnf_s"),
                             bias_attr=ParamAttr(name="gpt_lnf_b"))


def gpt_pretrain_program(cfg, batch_size, seq_len, optimizer_fn=None,
                         is_test=False):
    """Next-token LM: feeds token_ids/pos_ids/labels (N,T,1) int64 +
    loss_mask (N,T,1) float32 (1 = predict here); the loss is the masked
    mean of the fused tied-embedding head's per-token loss.
    ``optimizer_fn(loss)`` appends the training ops. Returns (main,
    startup, feed names, fetch dict)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        tok = layers.data("token_ids", [seq_len, 1], dtype="int64")
        pos = layers.data("pos_ids", [seq_len, 1], dtype="int64")
        lbl = layers.data("labels", [seq_len, 1], dtype="int64")
        lmask = layers.data("loss_mask", [seq_len, 1], dtype="float32")

        h = gpt_decoder(tok, pos, cfg, is_test=is_test)
        flat_h = layers.reshape(h, [-1, cfg.hidden_size])
        flat_lbl = layers.reshape(lbl, [-1, 1])
        emb = main.global_block().var("gpt_word_embedding")
        ce = layers.fused_mlm_head_loss(
            flat_h, emb, flat_lbl, cast_bf16=cfg.dtype == "bfloat16")
        mask = layers.reshape(lmask, [-1, 1])
        loss = layers.elementwise_div(
            layers.reduce_sum(layers.elementwise_mul(ce, mask)),
            layers.elementwise_add(
                layers.reduce_sum(mask),
                layers.fill_constant([1], "float32", 1e-8)))
        if optimizer_fn is not None:
            optimizer_fn(loss)
    feeds = ["token_ids", "pos_ids", "labels", "loss_mask"]
    return main, startup, feeds, {"loss": loss}


def _tied_logits(cfg, h, main):
    """Tied-embedding vocab projection of the decode program (it shares
    the train program's parameter names, so a trained scope decodes); in
    bf16 the products are summed into f32 logits."""
    emb = main.global_block().var("gpt_word_embedding")
    if cfg.dtype == "bfloat16":
        return layers.matmul(h, layers.cast(emb, "bfloat16"),
                             transpose_y=True, out_dtype="float32")
    return layers.matmul(h, emb, transpose_y=True)


def gpt_logits_program(cfg, seq_len):
    """Inference program: token_ids/pos_ids -> (N,T,vocab) f32 logits."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        tok = layers.data("token_ids", [seq_len, 1], dtype="int64")
        pos = layers.data("pos_ids", [seq_len, 1], dtype="int64")
        h = gpt_decoder(tok, pos, cfg, is_test=True)
        logits = _tied_logits(cfg, h, main)
    return main, startup, ["token_ids", "pos_ids"], {"logits": logits}


def greedy_generate(exe, cfg, prompt_tokens, max_new_tokens,
                    logits_program=None, temperature=0.0, seed=0):
    """Autoregressive decode: a full-prefix forward per new token at one
    static length (prompt + max_new; causal masking makes the padding
    positions irrelevant). temperature=0 -> greedy argmax, else sampling
    from numpy's RandomState(seed). prompt_tokens: (N, P) int. Returns
    (N, P + max_new) int64 tokens."""
    prompt = np.asarray(prompt_tokens, np.int64)
    n, p = prompt.shape
    total = p + max_new_tokens
    if total > cfg.max_position:
        # the position table would silently clamp past its last row
        raise ValueError(
            "prompt (%d) + max_new_tokens (%d) exceeds cfg.max_position "
            "(%d)" % (p, max_new_tokens, cfg.max_position))
    if logits_program is None:
        logits_program = gpt_logits_program(cfg, total)
    main, startup, feeds, fetch = logits_program
    toks = np.zeros((n, total), np.int64)
    toks[:, :p] = prompt
    pos = np.tile(np.arange(total).reshape(1, total, 1),
                  (n, 1, 1)).astype(np.int64)
    rng = np.random.RandomState(seed)
    for cur in range(p, total):
        out, = exe.run(main, feed={"token_ids": toks[:, :, None],
                                   "pos_ids": pos},
                       fetch_list=[fetch["logits"]], return_numpy=True)
        step_logits = np.asarray(out)[:, cur - 1, :]
        if temperature and temperature > 0:
            z = step_logits / temperature
            z = z - z.max(axis=-1, keepdims=True)
            probs = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
            nxt = np.array([rng.choice(cfg.vocab_size, p=probs[i])
                            for i in range(n)])
        else:
            nxt = step_logits.argmax(axis=-1)
        toks[:, cur] = nxt
    return toks


def synthetic_batch(cfg, batch_size, seq_len, seed=0):
    """Random-but-valid LM batch (labels are the tokens shifted left),
    drawn from numpy's RandomState(seed) exactly as the JAX package draws
    it."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size,
                       (batch_size, seq_len + 1)).astype(np.int64)
    pos = np.tile(np.arange(seq_len).reshape(1, seq_len, 1),
                  (batch_size, 1, 1)).astype(np.int64)
    return {"token_ids": toks[:, :-1, None],
            "pos_ids": pos,
            "labels": toks[:, 1:, None],
            "loss_mask": np.ones((batch_size, seq_len, 1), np.float32)}


__all__ = ["GPTConfig", "gpt_base", "decoder_block", "gpt_decoder",
           "gpt_pretrain_program", "gpt_logits_program", "greedy_generate",
           "synthetic_batch"]
