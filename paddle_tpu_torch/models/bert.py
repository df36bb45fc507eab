"""BERT-base / ERNIE encoder and MLM+NSP pretraining program (static
graph).

Counterpart of paddle_tpu/models/bert.py:1-256: the same layers, op
types, var and parameter names, so a model directory written by either
package serves in the other and the two pretraining programs serialize
the same. ``dtype="bfloat16"`` runs the encoder layers in bf16 (f32
embeddings, LayerNorm parameters, pooler and MLM head sums);
``recompute=True`` makes each training layer a ``recompute_segment``.
"""
import numpy as np

from .. import layers
from ..framework.program import Program, program_guard
from ..initializer import ConstantInitializer
from ..initializer import TruncatedNormalInitializer
from ..layers.attention import multi_head_attention
from ..param_attr import ParamAttr


class BertConfig(object):
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, ff_size=3072, max_position=512,
                 type_vocab_size=2, hidden_dropout=0.1, attn_dropout=0.1,
                 initializer_range=0.02, dtype="float32", tp=False,
                 recompute=False, attn_impl="auto"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ff_size = ff_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attn_dropout = attn_dropout
        self.initializer_range = initializer_range
        self.dtype = dtype
        # tensor-parallel sharding annotations, kept as Program metadata
        self.tp = tp
        self.attn_impl = attn_impl
        self.recompute = recompute


def bert_base(**kw):
    return BertConfig(**kw)


def _init(cfg):
    return TruncatedNormalInitializer(scale=cfg.initializer_range)


def _attr(cfg, name, sharding=None):
    return ParamAttr(name=name, initializer=_init(cfg),
                     sharding=sharding if cfg.tp else None)


def encoder_layer(x, attn_bias, cfg, name, is_test=False):
    """Post-LN transformer layer (BERT structure)."""
    d = cfg.hidden_size
    attn = multi_head_attention(
        x, None, None, attn_bias, d // cfg.num_heads, d // cfg.num_heads,
        d, n_head=cfg.num_heads, dropout_rate=cfg.attn_dropout,
        param_initializer=_init(cfg), name=name + "_multi_head_att",
        is_test=is_test, attn_impl=cfg.attn_impl)
    if cfg.hidden_dropout:
        attn = layers.dropout(attn, cfg.hidden_dropout, is_test=is_test,
                              dropout_implementation="upscale_in_train")
    x = layers.layer_norm(layers.elementwise_add(x, attn),
                          begin_norm_axis=2,
                          param_attr=ParamAttr(name=name + "_post_att_ln_s"),
                          bias_attr=ParamAttr(name=name + "_post_att_ln_b"))
    ff = layers.fc(x, cfg.ff_size, num_flatten_dims=2, act="gelu",
                   param_attr=_attr(cfg, name + "_ffn_fc_0.w_0",
                                    (None, "mp")),
                   bias_attr=ParamAttr(name=name + "_ffn_fc_0.b_0"))
    ff = layers.fc(ff, d, num_flatten_dims=2,
                   param_attr=_attr(cfg, name + "_ffn_fc_1.w_0",
                                    ("mp", None)),
                   bias_attr=ParamAttr(name=name + "_ffn_fc_1.b_0"))
    if cfg.hidden_dropout:
        ff = layers.dropout(ff, cfg.hidden_dropout, is_test=is_test,
                            dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, ff),
                             begin_norm_axis=2,
                             param_attr=ParamAttr(name=name + "_post_ffn_ln_s"),
                             bias_attr=ParamAttr(name=name + "_post_ffn_ln_b"))


def bert_encoder(src_ids, position_ids, sentence_ids, input_mask, cfg,
                 is_test=False, task_ids=None, task_vocab_size=16):
    """Returns (sequence_output (N,T,H), pooled [CLS] output (N,H)).
    task_ids (ERNIE 2.0) adds a task-type embedding."""
    emb = layers.embedding(
        src_ids, [cfg.vocab_size, cfg.hidden_size],
        param_attr=_attr(cfg, "word_embedding", ("mp", None)),
        dtype="float32")
    pos = layers.embedding(
        position_ids, [cfg.max_position, cfg.hidden_size],
        param_attr=ParamAttr(name="pos_embedding", initializer=_init(cfg)),
        dtype="float32")
    sent = layers.embedding(
        sentence_ids, [cfg.type_vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="sent_embedding", initializer=_init(cfg)),
        dtype="float32")
    x = layers.elementwise_add(layers.elementwise_add(emb, pos), sent)
    if task_ids is not None:
        task = layers.embedding(
            task_ids, [task_vocab_size, cfg.hidden_size],
            param_attr=ParamAttr(name="task_embedding",
                                 initializer=_init(cfg)),
            dtype="float32")
        x = layers.elementwise_add(x, task)
    x = layers.layer_norm(x, begin_norm_axis=2,
                          param_attr=ParamAttr(name="pre_encoder_ln_s"),
                          bias_attr=ParamAttr(name="pre_encoder_ln_b"))
    if cfg.hidden_dropout:
        x = layers.dropout(x, cfg.hidden_dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    if cfg.dtype == "bfloat16":
        x = layers.cast(x, "bfloat16")

    # attn bias: (N,1,1,T); mask 1=token/0=pad -> additive 0 / -1e4,
    # broadcast over heads and query positions
    mask_t = layers.transpose(input_mask, [0, 2, 1])   # (N,1,T)
    mask_t = layers.unsqueeze(mask_t, [1])             # (N,1,1,T)
    attn_bias = layers.scale(mask_t, scale=10000.0, bias=-10000.0)
    if cfg.dtype == "bfloat16":
        attn_bias = layers.cast(attn_bias, "bfloat16")

    for i in range(cfg.num_layers):
        if cfg.recompute and not is_test:
            x = layers.recompute_segment(
                lambda h, i=i: encoder_layer(
                    h, attn_bias, cfg, "encoder_layer_%d" % i,
                    is_test=is_test), [x])
        else:
            x = encoder_layer(x, attn_bias, cfg, "encoder_layer_%d" % i,
                              is_test=is_test)
    if cfg.dtype == "bfloat16":
        x = layers.cast(x, "float32")

    cls = layers.slice(x, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, [0, cfg.hidden_size])
    pooled = layers.fc(cls, cfg.hidden_size, act="tanh",
                       param_attr=ParamAttr(name="pooled_fc.w_0",
                                            initializer=_init(cfg)),
                       bias_attr=ParamAttr(name="pooled_fc.b_0"))
    return x, pooled


def bert_pretrain_program(cfg, batch_size, seq_len, max_preds_per_seq=20,
                          is_test=False, optimizer_fn=None):
    """Main and startup programs for MLM+NSP pretraining.

    Feeds: src_ids, pos_ids, sent_ids (N,T,1) int64; input_mask (N,T,1)
    float; mask_pos (N*max_preds,1) int64 flat indices into (N*T);
    mask_label (N*max_preds,1) int64; labels (N,1) int64 (NSP).
    ``optimizer_fn(loss)`` (e.g. ``optimizer.Adam(1e-4).minimize``)
    appends the training ops. Returns (main, startup, feed names, fetch
    dict).
    """
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src_ids = layers.data("src_ids", [seq_len, 1], dtype="int64")
        pos_ids = layers.data("pos_ids", [seq_len, 1], dtype="int64")
        sent_ids = layers.data("sent_ids", [seq_len, 1], dtype="int64")
        input_mask = layers.data("input_mask", [seq_len, 1],
                                 dtype="float32")
        mask_pos = layers.data("mask_pos", [1], dtype="int64")
        mask_label = layers.data("mask_label", [1], dtype="int64")
        nsp_label = layers.data("labels", [1], dtype="int64")

        seq_out, pooled = bert_encoder(src_ids, pos_ids, sent_ids,
                                       input_mask, cfg, is_test=is_test)

        # masked-LM head, decoded with the tied word embedding
        flat = layers.reshape(seq_out, [-1, cfg.hidden_size])
        picked = layers.gather(flat, mask_pos)
        trans = layers.fc(picked, cfg.hidden_size, act="gelu",
                          param_attr=ParamAttr(name="mask_lm_trans_fc.w_0",
                                               initializer=_init(cfg)),
                          bias_attr=ParamAttr(name="mask_lm_trans_fc.b_0"))
        trans = layers.layer_norm(
            trans, begin_norm_axis=1,
            param_attr=ParamAttr(name="mask_lm_trans_ln_s"),
            bias_attr=ParamAttr(name="mask_lm_trans_ln_b"))
        word_emb = main.global_block().var("word_embedding")
        mlm_bias = layers.create_parameter(
            [cfg.vocab_size], "float32", name="mask_lm_out_fc.b_0",
            default_initializer=ConstantInitializer(0.0))
        mlm_loss = layers.mean(layers.fused_mlm_head_loss(
            trans, word_emb, mask_label, bias=mlm_bias,
            cast_bf16=cfg.dtype == "bfloat16"))

        # next-sentence head
        nsp_logits = layers.fc(
            pooled, 2, param_attr=ParamAttr(name="next_sent_fc.w_0",
                                            initializer=_init(cfg)),
            bias_attr=ParamAttr(name="next_sent_fc.b_0"))
        nsp_loss, nsp_softmax = layers.softmax_with_cross_entropy(
            nsp_logits, nsp_label, return_softmax=True)
        nsp_acc = layers.accuracy(nsp_softmax, nsp_label)
        nsp_loss = layers.mean(nsp_loss)

        loss = layers.elementwise_add(mlm_loss, nsp_loss)
        if optimizer_fn is not None:
            optimizer_fn(loss)
    feeds = ["src_ids", "pos_ids", "sent_ids", "input_mask", "mask_pos",
             "mask_label", "labels"]
    fetch = {"loss": loss, "mlm_loss": mlm_loss, "nsp_loss": nsp_loss,
             "nsp_acc": nsp_acc}
    return main, startup, feeds, fetch


def synthetic_batch(cfg, batch_size, seq_len, max_preds_per_seq=20, seed=0):
    """Random-but-valid pretraining batch, drawn from numpy's
    RandomState(seed) exactly as the JAX package draws it."""
    rng = np.random.RandomState(seed)
    n, t = batch_size, seq_len
    src = rng.randint(0, cfg.vocab_size, (n, t, 1)).astype(np.int64)
    pos = np.tile(np.arange(t).reshape(1, t, 1), (n, 1, 1)).astype(np.int64)
    sent = np.zeros((n, t, 1), np.int64)
    sent[:, t // 2:, :] = 1
    mask = np.ones((n, t, 1), np.float32)
    mp = np.stack([rng.choice(t, max_preds_per_seq, replace=False) + i * t
                   for i in range(n)]).reshape(-1, 1).astype(np.int64)
    ml = rng.randint(0, cfg.vocab_size,
                     (n * max_preds_per_seq, 1)).astype(np.int64)
    nsp = rng.randint(0, 2, (n, 1)).astype(np.int64)
    return {"src_ids": src, "pos_ids": pos, "sent_ids": sent,
            "input_mask": mask, "mask_pos": mp, "mask_label": ml,
            "labels": nsp}


__all__ = ["BertConfig", "bert_base", "encoder_layer", "bert_encoder",
           "bert_pretrain_program", "synthetic_batch"]
