"""CRNN-CTC text recognition (counterpart of paddle_tpu/models/ocr.py;
reference: PaddlePaddle/models ocr_recognition, crnn_ctc_model.py).

Conv feature extractor -> columns as time steps -> bidirectional GRU ->
per-step logits over the classes and the blank -> warpctc loss; a greedy
CTC decode on the host for inference. As in the JAX package, the image
width is the time axis (the pools halve the height only).
"""
import numpy as np

from .. import layers
from ..contrib.layers import basic_gru
from ..framework import analysis
from ..framework.program import Program, program_guard

__all__ = ["crnn_ctc_program", "synthetic_ocr_batch", "ctc_greedy_decode"]


def _conv_pool(x, filters, is_test=False):
    y = layers.conv2d(x, num_filters=filters, filter_size=3, padding=1,
                      bias_attr=False)
    y = layers.batch_norm(y, act="relu", is_test=is_test)
    # pool the height only, keeping width = time
    return layers.pool2d(y, pool_size=[2, 1], pool_stride=[2, 1],
                         pool_type="max")


def crnn_ctc_program(num_classes=36, image_shape=(1, 32, 64),
                     hidden=64, max_label=16, optimizer_fn=None,
                     is_test=False):
    """(main, startup, feeds, fetches): fetches carry 'loss' (CTC) and
    'logits' (T, N, num_classes + 1; blank = num_classes)."""
    c, h, w = image_shape
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", [c, h, w], "float32")
        label = layers.data("label", [max_label], "int32")
        label_len = layers.data("label_len", [1], "int64")
        y = _conv_pool(img, 32, is_test)      # h/2
        y = _conv_pool(y, 64, is_test)        # h/4
        y = _conv_pool(y, 128, is_test)       # h/8
        # (N, C, H', W) -> time-major columns (N, W, C * H')
        ch, hh = y.shape[1], y.shape[2]
        y = layers.transpose(y, perm=[0, 3, 1, 2])
        feat = layers.reshape(y, [-1, w, ch * hh])
        rnn_out, _ = basic_gru(feat, None, hidden_size=hidden,
                               bidirectional=True)
        logits = layers.fc(rnn_out, size=num_classes + 1,
                           num_flatten_dims=2)
        logits_tm = layers.transpose(logits, perm=[1, 0, 2])  # (T, N, C)
        in_len = layers.fill_constant_batch_size_like(
            label_len, shape=[-1], dtype="int64", value=w)
        loss = layers.reduce_mean(layers.warpctc(
            logits_tm, label, blank=num_classes,
            input_length=in_len, label_length=layers.reshape(label_len,
                                                             [-1])))
        if optimizer_fn is not None:
            optimizer_fn(loss)
    # dce allowlist (the JAX package's): the bidirectional rnn emits
    # last-state slice/squeeze/stack ops the CTC head never reads; they
    # are dead by the API's shape and the report would flag them at
    # every compile
    analysis.allowlist(main, analysis.PASS_DCE,
                       reason="rnn last-state chain unused by the "
                              "CTC head")
    return main, startup, \
        {"image": img, "label": label, "label_len": label_len}, \
        {"loss": loss, "logits": logits_tm}


def ctc_greedy_decode(logits_tm, blank):
    """Host-side greedy CTC collapse of (T, N, C) logits -> a list of
    label lists (repeats merged, blanks dropped)."""
    ids = np.argmax(np.asarray(logits_tm), axis=-1)  # (T, N)
    outs = []
    for n in range(ids.shape[1]):
        seq, prev = [], -1
        for t in range(ids.shape[0]):
            k = int(ids[t, n])
            if k != prev and k != blank:
                seq.append(k)
            prev = k
        outs.append(seq)
    return outs


def synthetic_ocr_batch(batch, image_shape=(1, 32, 64), num_classes=36,
                        max_label=16, seed=0):
    """Images whose column intensity encodes the label sequence, so the
    model has signal to fit; the JAX package's draws from the same
    seed."""
    rng = np.random.RandomState(seed)
    c, h, w = image_shape
    imgs = rng.rand(batch, c, h, w).astype(np.float32) * 0.1
    labels = np.zeros((batch, max_label), np.int32)
    lens = np.zeros((batch, 1), np.int64)
    for b in range(batch):
        n = rng.randint(2, max_label // 2)
        lab = rng.randint(0, num_classes, n)
        labels[b, :n] = lab
        lens[b, 0] = n
        # each glyph a vertical band of class-keyed intensity
        band = w // max(n, 1)
        for i, k in enumerate(lab):
            imgs[b, :, :, i * band:(i + 1) * band] += \
                (k + 1) / float(num_classes + 1)
    return {"image": imgs, "label": labels, "label_len": lens}
