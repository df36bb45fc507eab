"""The search space (counterpart of paddle_tpu/contrib/slim/nas/
search_space.py; reference contrib/slim/nas/search_space.py): the
user-subclassed definition of
the token space."""

__all__ = ["SearchSpace"]


class SearchSpace(object):
    def init_tokens(self):
        """Initial token list."""
        raise NotImplementedError()

    def range_table(self):
        """Per-position exclusive upper bounds."""
        raise NotImplementedError()

    def create_net(self, tokens=None):
        """Build (train_program, eval_program, ...) for the tokens."""
        raise NotImplementedError()
