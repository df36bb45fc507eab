"""DeepFM CTR model (static graph), the counterpart of
paddle_tpu/models/deepfm.py: Criteo-style input, 13 dense features and
26 categorical ids hashed into one feature space; a first-order
(feature_dim, 1) table, an FM second-order term over a (feature_dim,
embedding_size) table, and a 400-400-400 deep tower, summed into one
logit. Same parameter names as the JAX package's.

``shard_embeddings=True`` (the tables row-sharded over a mesh) waits for
the port's ``torch.distributed`` slice and raises NotPortedError.
"""
import math

import numpy as np

from .. import layers
from ..framework.program import Program, program_guard
from ..initializer import NormalInitializer, TruncatedNormalInitializer
from ..ops.registry import NotPortedError
from ..param_attr import ParamAttr


def deepfm(raw_dense, sparse_ids, feature_dim, embedding_size=10,
           layer_sizes=(400, 400, 400), sparse_fields=26,
           shard_embeddings=False, is_test=False):
    """raw_dense: (N, 13) float; sparse_ids: (N, 26, 1) int64.
    Returns (logit (N, 1), predict (N, 1) probability)."""
    if shard_embeddings:
        raise NotPortedError(
            "deepfm(shard_embeddings=True) shards the tables over a mesh; "
            "it arrives with the torch.distributed slice of "
            "paddle_tpu_torch")
    init = TruncatedNormalInitializer(
        scale=1.0 / math.sqrt(feature_dim))
    emb_attr = ParamAttr(name="feat_embeddings", initializer=init)
    w1_attr = ParamAttr(name="feat_weights_1st", initializer=init)

    # first order
    w1 = layers.embedding(sparse_ids, [feature_dim, 1], param_attr=w1_attr)
    first_sparse = layers.reduce_sum(layers.reshape(
        w1, [0, sparse_fields]), dim=1, keep_dim=True)
    dense_w = layers.fc(raw_dense, 1, bias_attr=False,
                        param_attr=ParamAttr(name="dense_w1"))
    y_first = layers.elementwise_add(first_sparse, dense_w)

    # second order: the FM sum-square trick
    emb = layers.embedding(sparse_ids, [feature_dim, embedding_size],
                           param_attr=emb_attr)          # (N, 26, E)
    summed_sq = layers.square(layers.reduce_sum(emb, dim=1))
    sq_summed = layers.reduce_sum(layers.square(emb), dim=1)
    y_second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(summed_sq, sq_summed),
                          dim=1, keep_dim=True), scale=0.5)

    # deep tower
    deep = layers.reshape(emb, [0, sparse_fields * embedding_size])
    deep = layers.concat([deep, raw_dense], axis=1)
    for i, sz in enumerate(layer_sizes):
        deep = layers.fc(deep, sz, act="relu",
                         param_attr=ParamAttr(
                             name="deep_fc_%d.w" % i,
                             initializer=NormalInitializer(
                                 0.0, math.sqrt(2.0 / sz))),
                         bias_attr=ParamAttr(name="deep_fc_%d.b" % i))
    y_deep = layers.fc(deep, 1, param_attr=ParamAttr(name="deep_out.w"),
                       bias_attr=ParamAttr(name="deep_out.b"))

    logit = layers.elementwise_add(
        layers.elementwise_add(y_first, y_second), y_deep)
    return logit, layers.sigmoid(logit)


def deepfm_train_program(feature_dim=1000000, embedding_size=10,
                         sparse_fields=26, dense_dim=13,
                         optimizer_fn=None, shard_embeddings=False,
                         is_test=False):
    """(main, startup, feed names, {"loss", "auc", "predict"}): the mean
    sigmoid CE of the logit against a float label, and the streaming AUC
    of the predictions; ``optimizer_fn(loss)`` appends the update."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        dense = layers.data("dense_input", [dense_dim], dtype="float32")
        sparse = layers.data("sparse_input", [sparse_fields, 1],
                             dtype="int64")
        label = layers.data("label", [1], dtype="float32")
        logit, predict = deepfm(dense, sparse, feature_dim, embedding_size,
                                sparse_fields=sparse_fields,
                                shard_embeddings=shard_embeddings,
                                is_test=is_test)
        loss = layers.mean(
            layers.sigmoid_cross_entropy_with_logits(logit, label))
        two_col = layers.concat(
            [layers.elementwise_sub(layers.ones_like(predict), predict),
             predict], axis=1)
        auc_out, _ = layers.auc(two_col, layers.cast(label, "int64"))
        if optimizer_fn is not None:
            optimizer_fn(loss)
    return main, startup, ["dense_input", "sparse_input", "label"], \
        {"loss": loss, "auc": auc_out, "predict": predict}


def synthetic_batch(batch_size, feature_dim=1000000, sparse_fields=26,
                    dense_dim=13, seed=0):
    """A batch of the JAX package's ``synthetic_batch``: the same numbers
    for the same arguments."""
    rng = np.random.RandomState(seed)
    return {
        "dense_input": rng.rand(batch_size, dense_dim).astype(np.float32),
        "sparse_input": rng.randint(
            0, feature_dim, (batch_size, sparse_fields, 1)).astype(np.int64),
        "label": (rng.rand(batch_size, 1) > 0.5).astype(np.float32),
    }
