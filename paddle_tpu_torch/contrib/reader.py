"""Multi-process reader decoration (counterpart of
paddle_tpu/contrib/reader.py; fluid's contrib/reader/distributed_reader.py).

Round-robin batch sharding for data-parallel trainers under the
PADDLE_TRAINER environment contract: trainer i of n consumes every n-th
batch. One card is one trainer (n = 1: every batch).
"""
import os

__all__ = ["distributed_batch_reader"]


def distributed_batch_reader(batch_reader):
    """Shard a batch reader across PADDLE_TRAINERS_NUM processes
    (ref :21): trainer ``i`` yields batches ``i, i+n, i+2n, ...``."""
    trainers_num = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    assert trainer_id < trainers_num, \
        "PADDLE_TRAINER_ID %d out of range for %d trainers" % (
            trainer_id, trainers_num)

    def decorated():
        for batch_id, data in enumerate(batch_reader()):
            if batch_id % trainers_num == trainer_id:
                yield data

    return decorated
