"""The book's smoke-test models (counterpart of
paddle_tpu/models/simple.py, reference tests/book/): an mnist-style MLP
and CBOW word2vec, with the JAX package's parameter names."""
from .. import layers
from ..framework.program import Program, program_guard
from ..param_attr import ParamAttr


def mlp_classifier_program(input_dim=784, hidden=(200, 200), classes=10,
                           optimizer_fn=None):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", [input_dim], dtype="float32")
        y = layers.data("y", [1], dtype="int64")
        h = x
        for sz in hidden:
            h = layers.fc(h, sz, act="relu")
        logits = layers.fc(h, classes)
        loss, softmax = layers.softmax_with_cross_entropy(
            logits, y, return_softmax=True)
        loss = layers.mean(loss)
        acc = layers.accuracy(softmax, y)
        if optimizer_fn is not None:
            optimizer_fn(loss)
    return main, startup, ["x", "y"], {"loss": loss, "acc": acc}


def word2vec_program(vocab_size=1000, emb_size=64, window=2,
                     optimizer_fn=None):
    """CBOW word2vec (reference book/04.word2vec)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        ctx_words = []
        for i in range(2 * window):
            w = layers.data("ctx_%d" % i, [1], dtype="int64")
            ctx_words.append(w)
        target = layers.data("target", [1], dtype="int64")
        embs = [layers.embedding(
            w, [vocab_size, emb_size],
            param_attr=ParamAttr(name="shared_w"))
            for w in ctx_words]
        stacked = layers.stack(embs, axis=1)       # (N, 2w, E)
        avg = layers.reduce_mean(stacked, dim=1)
        logits = layers.fc(avg, vocab_size)
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, target))
        if optimizer_fn is not None:
            optimizer_fn(loss)
    feeds = ["ctx_%d" % i for i in range(2 * window)] + ["target"]
    return main, startup, feeds, {"loss": loss}
