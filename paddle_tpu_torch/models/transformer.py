"""Transformer-base NMT (WMT en-de geometry): training, greedy and
beam-search decode (static graph).

Counterpart of paddle_tpu/models/transformer.py: the same layers, op
types, var and parameter names, so the two packages' programs serialize
the same and weights carry across with ``io.set_params_from_numpy``.
Post-LN encoder-decoder with sinusoid positions, label-smoothed soft-label
cross-entropy, and the decoder's causal self-attention through the fused
attention op (the flash-attention kernels on the card). Both decoders are
unrolled at build time with static shapes: with ``use_cache`` each step
embeds only the newest token and attends over per-layer K/V caches
(``layers.attention.multi_head_attention(cache=...)``); without it the
prefix is re-decoded every step (the equivalence oracle). Beam search
keeps the beams as a flattened (N * beam) batch and expands the frontier
with ``topk`` and ``gather``. Tensor-parallel annotations (``tp``) belong
to the multi-GPU slice and raise NotPortedError.
"""
import numpy as np

from .. import layers
from ..framework.program import Program, program_guard
from ..initializer import NormalInitializer, XavierInitializer
from ..layer_helper import LayerHelper
from ..layers.attention import multi_head_attention, mha_kv_projection
from ..ops.registry import NotPortedError
from ..param_attr import ParamAttr


class TransformerConfig(object):
    def __init__(self, src_vocab=30000, trg_vocab=30000, max_length=256,
                 d_model=512, d_inner=2048, n_head=8, n_layer=6,
                 dropout=0.1, label_smooth_eps=0.1, tp=False):
        if tp:
            raise NotPortedError(
                "TransformerConfig(tp=True) shards the model over a "
                "tensor-parallel mesh; it arrives with the multi-GPU slice "
                "of paddle_tpu_torch")
        self.src_vocab = src_vocab
        self.trg_vocab = trg_vocab
        self.max_length = max_length
        self.d_model = d_model
        self.d_inner = d_inner
        self.n_head = n_head
        self.n_layer = n_layer
        self.dropout = dropout
        self.label_smooth_eps = label_smooth_eps


def _embed(ids, vocab, cfg, name, is_test, pos_offset=0):
    emb = layers.embedding(
        ids, [vocab, cfg.d_model],
        param_attr=ParamAttr(name=name, initializer=NormalInitializer(
            0.0, cfg.d_model ** -0.5)))
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    out = _pos_enc(emb, cfg, pos_offset)
    if cfg.dropout:
        out = layers.dropout(out, cfg.dropout, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return out


def _pos_enc(x, cfg, pos_offset=0):
    h = LayerHelper("pos_enc")
    out = h.create_variable_for_type_inference(x.dtype, x.shape)
    h.append_op("add_position_encoding", inputs={"X": [x.name]},
                outputs={"Out": [out.name]},
                attrs={"alpha": 1.0, "beta": 1.0,
                       "pos_offset": int(pos_offset)})
    return out


def _ffn(x, cfg, name, is_test):
    h = layers.fc(x, cfg.d_inner, num_flatten_dims=2, act="relu",
                  param_attr=ParamAttr(name=name + "_fc0.w",
                                       initializer=XavierInitializer()),
                  bias_attr=ParamAttr(name=name + "_fc0.b"))
    if cfg.dropout:
        h = layers.dropout(h, cfg.dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return layers.fc(h, cfg.d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(name=name + "_fc1.w",
                                          initializer=XavierInitializer()),
                     bias_attr=ParamAttr(name=name + "_fc1.b"))


def _prepost(x, residual, cfg, name, is_test):
    """Residual add and layer norm (the reference's post-process)."""
    if residual is not None:
        x = layers.elementwise_add(x, residual)
    return layers.layer_norm(x, begin_norm_axis=2,
                             param_attr=ParamAttr(name=name + "_ln_s"),
                             bias_attr=ParamAttr(name=name + "_ln_b"))


def _mha(x, kv, bias, cfg, name, is_test, dropout, cache=None,
         causal=False):
    dh = cfg.d_model // cfg.n_head
    return multi_head_attention(x, kv, kv, bias, dh, dh, cfg.d_model,
                                cfg.n_head, dropout, cache=cache, name=name,
                                is_test=is_test, causal=causal)


def encoder(src_emb, src_bias, cfg, is_test):
    x = src_emb
    for i in range(cfg.n_layer):
        name = "enc_%d" % i
        attn = _mha(x, None, src_bias, cfg, name + "_att", is_test,
                    cfg.dropout)
        x = _prepost(attn, x, cfg, name + "_post_att", is_test)
        ff = _ffn(x, cfg, name + "_ffn", is_test)
        x = _prepost(ff, x, cfg, name + "_post_ffn", is_test)
    return x


def decoder(trg_emb, enc_out, trg_bias, src_bias, cfg, is_test):
    x = trg_emb
    for i in range(cfg.n_layer):
        name = "dec_%d" % i
        self_attn = _mha(x, None, trg_bias, cfg, name + "_self_att",
                         is_test, cfg.dropout, causal=True)
        x = _prepost(self_attn, x, cfg, name + "_post_self", is_test)
        cross = _mha(x, enc_out, src_bias, cfg, name + "_cross_att",
                     is_test, cfg.dropout)
        x = _prepost(cross, x, cfg, name + "_post_cross", is_test)
        ff = _ffn(x, cfg, name + "_ffn", is_test)
        x = _prepost(ff, x, cfg, name + "_post_ffn", is_test)
    return x


def _embed_step(ids_t, cfg, name, pos):
    """Embed one decode-step token at absolute position ``pos``."""
    return _embed(ids_t, cfg.trg_vocab, cfg, name, True, pos_offset=pos)


def init_decoder_caches(cfg, enc_out, name_prefix="dec"):
    """Per-layer caches for incremental decode: self-attention K/V start
    empty and grow by one position a step; cross-attention K/V are
    projected from the encoder output once."""
    caches = []
    dh = cfg.d_model // cfg.n_head
    for i in range(cfg.n_layer):
        sk, sv = mha_kv_projection(enc_out, enc_out, dh, dh, cfg.n_head,
                                   name="%s_%d_cross_att" % (name_prefix, i))
        caches.append({"self": {"k": None, "v": None},
                       "cross": {"static_k": sk, "static_v": sv}})
    return caches


def decoder_cached_step(x_t, caches, src_bias, cfg, name_prefix="dec"):
    """One decoder pass over the newest token x_t (N, 1, D) against the
    caches, which it extends with this step's K/V."""
    x = x_t
    for i in range(cfg.n_layer):
        name = "%s_%d" % (name_prefix, i)
        self_attn = _mha(x, None, None, cfg, name + "_self_att", True, 0.0,
                         cache=caches[i]["self"], causal=True)
        x = _prepost(self_attn, x, cfg, name + "_post_self", True)
        cross = _mha(x, None, src_bias, cfg, name + "_cross_att", True, 0.0,
                     cache=caches[i]["cross"])
        x = _prepost(cross, x, cfg, name + "_post_cross", True)
        ff = _ffn(x, cfg, name + "_ffn", True)
        x = _prepost(ff, x, cfg, name + "_post_ffn", True)
    return x


def _attn_bias(mask):
    """(N, T, 1) 1/0 mask -> (N, 1, 1, T) additive bias."""
    m = layers.transpose(mask, [0, 2, 1])
    m = layers.unsqueeze(m, [1])
    return layers.scale(m, scale=10000.0, bias=-10000.0)


def _logits(dec_out, cfg):
    return layers.fc(dec_out, cfg.trg_vocab, num_flatten_dims=2,
                     param_attr=ParamAttr(name="dec_out_fc.w"),
                     bias_attr=False)


def _source(cfg, src_len):
    """The decode programs' feeds and encoder: (src_ids, src_bias,
    enc_out)."""
    src_ids = layers.data("src_ids", [src_len, 1], dtype="int64")
    src_mask = layers.data("src_mask", [src_len, 1], dtype="float32")
    src_bias = _attn_bias(src_mask)
    enc_in = _embed(src_ids, cfg.src_vocab, cfg, "src_word_emb", True)
    return src_ids, src_bias, encoder(enc_in, src_bias, cfg, True)


def transformer_train_program(cfg, src_len, trg_len, optimizer_fn=None,
                              is_test=False):
    """Feeds: src_ids (N,S,1), src_mask (N,S,1), trg_ids (N,T,1),
    trg_mask (N,T,1), lbl_ids (N,T,1). Returns (main, startup, feed
    names, {"loss": the token-mean cost})."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src_ids = layers.data("src_ids", [src_len, 1], dtype="int64")
        src_mask = layers.data("src_mask", [src_len, 1], dtype="float32")
        trg_ids = layers.data("trg_ids", [trg_len, 1], dtype="int64")
        trg_mask = layers.data("trg_mask", [trg_len, 1], dtype="float32")
        lbl = layers.data("lbl_ids", [trg_len, 1], dtype="int64")

        src_bias = _attn_bias(src_mask)
        trg_bias = _attn_bias(trg_mask)
        enc_in = _embed(src_ids, cfg.src_vocab, cfg, "src_word_emb", is_test)
        enc_out = encoder(enc_in, src_bias, cfg, is_test)
        dec_in = _embed(trg_ids, cfg.trg_vocab, cfg, "trg_word_emb", is_test)
        dec_out = decoder(dec_in, enc_out, trg_bias, src_bias, cfg, is_test)

        logits = layers.fc(dec_out, cfg.trg_vocab, num_flatten_dims=2,
                           param_attr=ParamAttr(
                               name="dec_out_fc.w",
                               initializer=XavierInitializer()),
                           bias_attr=False)
        if cfg.label_smooth_eps:
            smooth = layers.label_smooth(
                layers.one_hot(lbl, cfg.trg_vocab),
                epsilon=cfg.label_smooth_eps)
            cost = layers.softmax_with_cross_entropy(logits, smooth,
                                                     soft_label=True)
        else:
            cost = layers.softmax_with_cross_entropy(logits, lbl)
        weighted = layers.elementwise_mul(cost, trg_mask)
        sum_cost = layers.reduce_sum(weighted)
        token_num = layers.reduce_sum(trg_mask)
        token_num.stop_gradient = True
        avg_cost = layers.elementwise_div(sum_cost, token_num)
        if optimizer_fn is not None:
            optimizer_fn(avg_cost)
    return main, startup, ["src_ids", "src_mask", "trg_ids", "trg_mask",
                           "lbl_ids"], {"loss": avg_cost}


def greedy_decode_program(cfg, src_len, max_out_len, use_cache=True):
    """Greedy decode from BOS 0: out_ids (N, max_out_len, 1). With
    ``use_cache`` each step decodes the newest token against the K/V
    caches; without it the prefix is re-decoded every step."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src_ids, src_bias, enc_out = _source(cfg, src_len)
        if use_cache:
            caches = init_decoder_caches(cfg, enc_out)
            bos = layers.fill_constant_batch_size_like(
                src_ids, [-1, 1, 1], "int64", 0)
            tokens = [bos]
            x_t = _embed_step(bos, cfg, "trg_word_emb", 0)
            for t in range(max_out_len - 1):
                logits = _logits(decoder_cached_step(x_t, caches, src_bias,
                                                     cfg), cfg)  # (N,1,V)
                nxt = layers.unsqueeze(layers.argmax(logits, axis=-1), [2])
                tokens.append(nxt)
                if t + 1 < max_out_len - 1:
                    x_t = _embed_step(nxt, cfg, "trg_word_emb", t + 1)
            trg = layers.concat(tokens, axis=1)            # (N,T,1)
            return main, startup, ["src_ids", "src_mask"], {"out_ids": trg}

        trg = layers.fill_constant_batch_size_like(
            src_ids, [-1, max_out_len, 1], "int64", 0)
        ones = layers.fill_constant_batch_size_like(
            src_ids, [-1, max_out_len, 1], "float32", 1.0)
        trg_bias = _attn_bias(ones)
        for t in range(max_out_len - 1):
            dec_in = _embed(trg, cfg.trg_vocab, cfg, "trg_word_emb", True)
            logits = _logits(decoder(dec_in, enc_out, trg_bias, src_bias,
                                     cfg, True), cfg)
            step_logits = layers.slice(logits, axes=[1], starts=[t],
                                       ends=[t + 1])
            nxt = layers.unsqueeze(layers.argmax(step_logits, axis=-1), [2])
            # write position t + 1
            before = layers.slice(trg, axes=[1], starts=[0], ends=[t + 1])
            after = layers.slice(trg, axes=[1], starts=[t + 2],
                                 ends=[max_out_len])
            trg = layers.concat([before, nxt, after], axis=1)
    return main, startup, ["src_ids", "src_mask"], {"out_ids": trg}


def synthetic_batch(cfg, batch, src_len, trg_len, seed=0):
    """A training batch drawn from numpy's RandomState(seed) exactly as
    the JAX package draws it."""
    rng = np.random.RandomState(seed)
    return {
        "src_ids": rng.randint(1, cfg.src_vocab,
                               (batch, src_len, 1)).astype(np.int64),
        "src_mask": np.ones((batch, src_len, 1), np.float32),
        "trg_ids": rng.randint(1, cfg.trg_vocab,
                               (batch, trg_len, 1)).astype(np.int64),
        "trg_mask": np.ones((batch, trg_len, 1), np.float32),
        "lbl_ids": rng.randint(1, cfg.trg_vocab,
                               (batch, trg_len, 1)).astype(np.int64),
    }


def _beam_step(logits, scores, row_idx, cfg, b):
    """Expand every beam by every word and keep the best ``b`` of each
    source row: (top scores (N,B), source rows of the kept beams in the
    flattened (N*B) batch, their words (N,B))."""
    v = cfg.trg_vocab
    logp = layers.log_softmax(layers.reshape(logits, [-1, v]))   # (N*B,V)
    logp_nbv = layers.reshape(logp, [-1, b * v])
    prev = layers.reshape(scores, [-1, b, 1])
    prev = layers.expand(prev, [1, 1, v])
    prev = layers.reshape(prev, [-1, b * v])
    total = layers.elementwise_add(logp_nbv, prev)
    top_scores, top_idx = layers.topk(total, k=b)                # (N,B)
    beam_sel = layers.cast(
        layers.elementwise_floordiv(
            top_idx, layers.fill_constant([1], "int64", v)), "int64")
    word_sel = layers.cast(layers.elementwise_sub(
        top_idx, layers.scale(beam_sel, scale=float(v))), "int64")
    flat_rows = layers.reshape(
        layers.elementwise_add(layers.scale(row_idx, scale=float(b)),
                               beam_sel), [-1])                  # (N*B,)
    return top_scores, flat_rows, word_sel


def beam_search_decode_program(cfg, src_len, max_out_len, beam_size=4,
                               bos_id=0, eos_id=1, len_penalty=0.6,
                               use_cache=True):
    """Beam-search decode with static shapes: the beams are a flattened
    (N * beam) batch, the frontier expanded with topk and gather. With
    ``use_cache`` each step decodes the newest token against the K/V
    caches, which follow their source beam on selection; without it the
    prefix is re-decoded every step. Returns (main, startup, feed names,
    {"out_ids": (N, beam, T, 1), "scores": (N, beam)})."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src_ids, src_bias, enc_out = _source(cfg, src_len)
        b, t_max = beam_size, max_out_len

        # the encoder state tiled across beams: (N,S,D) -> (N*B,S,D)
        enc_rep = layers.unsqueeze(enc_out, [1])
        enc_rep = layers.expand(enc_rep, [1, b, 1, 1])
        enc_rep = layers.reshape(enc_rep, [-1, src_len, cfg.d_model])
        bias_rep = layers.unsqueeze(src_bias, [1])
        bias_rep = layers.expand(bias_rep, [1, b, 1, 1, 1])
        bias_rep = layers.reshape(bias_rep, [-1, 1, 1, src_len])

        # scores (N,B): beam 0 at 0, the others at -1e9, so the first
        # expansion draws B distinct words from beam 0
        zeros_nb = layers.fill_constant_batch_size_like(
            src_ids, [-1, b], "float32", 0.0)
        init_row = layers.assign(
            np.array([[0.0] + [-1e9] * (b - 1)], dtype=np.float32))
        scores = layers.elementwise_add(zeros_nb, init_row)
        # each (N,B) entry's source row, from a cumsum of ones
        ones_nb = layers.fill_constant_batch_size_like(
            src_ids, [-1, b], "float32", 1.0)
        row_idx = layers.cast(
            layers.scale(layers.cumsum(ones_nb, axis=0), bias=-1.0),
            "int64")                                          # (N,B)

        if use_cache:
            # cross-attention K/V projected from the untiled encoder
            # output (once per source row), then tiled across beams
            caches = init_decoder_caches(cfg, enc_out)
            dh = cfg.d_model // cfg.n_head
            for c in caches:
                for key in ("static_k", "static_v"):
                    x = layers.unsqueeze(c["cross"][key], [1])
                    x = layers.expand(x, [1, b, 1, 1, 1])
                    c["cross"][key] = layers.reshape(
                        x, [-1, cfg.n_head, src_len, dh])
            bos = layers.fill_constant_batch_size_like(
                enc_rep, [-1, 1, 1], "int64", float(bos_id))
            ids_mat = layers.reshape(bos, [-1, 1])            # (N*B, t+1)
            x_t = _embed_step(bos, cfg, "trg_word_emb", 0)
            for t in range(t_max - 1):
                logits = _logits(decoder_cached_step(x_t, caches, bias_rep,
                                                     cfg), cfg)
                scores, flat_rows, word_sel = _beam_step(
                    logits, scores, row_idx, cfg, b)
                word_col = layers.reshape(word_sel, [-1, 1])
                # the token history and every layer's self-attention
                # cache follow their source beam
                ids_mat = layers.concat(
                    [layers.gather(ids_mat, flat_rows), word_col], axis=1)
                for c in caches:
                    c["self"]["k"] = layers.gather(c["self"]["k"], flat_rows)
                    c["self"]["v"] = layers.gather(c["self"]["v"], flat_rows)
                if t + 1 < t_max - 1:
                    x_t = _embed_step(layers.reshape(word_col, [-1, 1, 1]),
                                      cfg, "trg_word_emb", t + 1)
            out_ids = layers.reshape(ids_mat, [-1, b, t_max, 1])
            final_scores = layers.scale(
                scores, scale=1.0 / (t_max ** len_penalty))
            return main, startup, ["src_ids", "src_mask"], \
                {"out_ids": out_ids, "scores": final_scores}

        # the full-history buffer of the re-decode path, at BOS
        ids = layers.fill_constant_batch_size_like(
            enc_rep, [-1, t_max, 1], "int64", float(bos_id))
        ones_mask = layers.fill_constant_batch_size_like(
            enc_rep, [-1, t_max, 1], "float32", 1.0)
        trg_bias = _attn_bias(ones_mask)
        for t in range(t_max - 1):
            dec_in = _embed(ids, cfg.trg_vocab, cfg, "trg_word_emb", True)
            logits = _logits(decoder(dec_in, enc_rep, trg_bias, bias_rep,
                                     cfg, True), cfg)
            step_logits = layers.slice(logits, axes=[1], starts=[t],
                                       ends=[t + 1])          # (N*B,1,V)
            scores, flat_rows, word_sel = _beam_step(
                step_logits, scores, row_idx, cfg, b)
            ids_kept = layers.gather(
                layers.reshape(ids, [-1, t_max]), flat_rows)  # (N*B,T)
            before = layers.slice(ids_kept, axes=[1], starts=[0],
                                  ends=[t + 1])
            after = layers.slice(ids_kept, axes=[1], starts=[t + 2],
                                 ends=[t_max])
            word_col = layers.reshape(word_sel, [-1, 1])
            ids = layers.reshape(
                layers.concat([before, word_col, after], axis=1),
                [-1, t_max, 1])

        out_ids = layers.reshape(ids, [-1, b, t_max, 1])
        final_scores = layers.scale(scores,
                                    scale=1.0 / (t_max ** len_penalty))
    return main, startup, ["src_ids", "src_mask"], \
        {"out_ids": out_ids, "scores": final_scores}


__all__ = ["TransformerConfig", "encoder", "decoder", "init_decoder_caches",
           "decoder_cached_step", "transformer_train_program",
           "greedy_decode_program", "beam_search_decode_program",
           "synthetic_batch"]
