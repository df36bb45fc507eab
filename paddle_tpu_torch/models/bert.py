"""BERT-base / ERNIE encoder (static graph).

Counterpart of paddle_tpu/models/bert.py's encoder: the same layers, op
types and parameter names, so a model directory written by either
package serves in the other. The pretraining heads (masked-LM and NSP
losses) and ``recompute`` arrive with the training slice.
"""
from .. import layers
from ..initializer import TruncatedNormalInitializer
from ..layers.attention import multi_head_attention
from ..ops.registry import NotPortedError
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
    if cfg.recompute and not is_test:
        raise NotPortedError(
            "BertConfig(recompute=True) rematerializes layers in backward; "
            "it arrives with the BERT training slice of paddle_tpu_torch")
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


__all__ = ["BertConfig", "bert_base", "encoder_layer", "bert_encoder"]
