"""LightNAS (counterpart of paddle_tpu/contrib/slim/nas/
light_nas_strategy.py; reference contrib/slim/nas/light_nas_strategy.py),
reduced to its core: a simulated-annealing search loop over a
SearchSpace, driven by a reward callback (the reference wires this into
the Compressor event loop and a controller server; evaluation is the
caller's concern here)."""
from ..searcher.controller import SAController

__all__ = ["LightNASStrategy"]


class LightNASStrategy(object):
    def __init__(self, search_space, reduce_rate=0.85,
                 init_temperature=1024, search_steps=100, seed=0):
        self._space = search_space
        self._controller = SAController(
            reduce_rate=reduce_rate, init_temperature=init_temperature,
            seed=seed)
        self._search_steps = search_steps

    def search(self, reward_func, constrain_func=None):
        """Run the SA loop: reward_func(tokens) -> float. Returns
        (best_tokens, best_reward)."""
        self._controller.reset(self._space.range_table(),
                               self._space.init_tokens(), constrain_func)
        tokens = list(self._space.init_tokens())
        self._controller.update(tokens, reward_func(tokens))
        for _ in range(self._search_steps):
            tokens = self._controller.next_tokens()
            self._controller.update(tokens, reward_func(tokens))
        return self._controller.best_tokens, self._controller.max_reward
