"""Lookup-table checkpoint conversion (counterpart of paddle_tpu/contrib/
utils/lookup_table_utils.py; reference contrib/utils/
lookup_table_utils.py). The reference converted a parameter server's
distributed lookup-table checkpoints into inference programs. The port
has no parameter server: on one card an embedding is an ordinary table
saved by ``io.save_persistables`` or ``io.save_checkpoint``, and tables
sharded across cards (``deepfm(shard_embeddings=True)``, which raises
NotPortedError) arrive with the torch.distributed slice. So the
conversion is the ordinary save and load; these names point at it."""

__all__ = ["convert_dist_to_sparse_program",
           "load_persistables_for_increment",
           "load_persistables_for_inference"]


def convert_dist_to_sparse_program(program):
    """The program as it is: an embedding with ``is_distributed=True``
    runs as one table on one card."""
    return program


def load_persistables_for_increment(dirname, executor, program,
                                    lookup_table_var=None,
                                    lookup_table_var_path=None):
    from ... import io
    io.load_persistables(executor, dirname, main_program=program)


def load_persistables_for_inference(dirname, executor, program,
                                    lookup_table_var_name=None):
    from ... import io
    io.load_persistables(executor, dirname, main_program=program)
