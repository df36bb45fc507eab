"""Token-search controllers (counterpart of paddle_tpu/contrib/slim/
searcher/controller.py; reference contrib/slim/searcher/controller.py:
SAController drives LightNAS by simulated annealing over an integer
token list). Deterministic: a seeded ``np.random.RandomState`` of its own
instead of global numpy randomness, so a search replays, and draws what
the JAX package's controller of the same seed draws, token for token."""
import math

import numpy as np

__all__ = ["EvolutionaryController", "SAController"]


class EvolutionaryController(object):
    """Base controller: propose tokens, learn from rewards."""

    def reset(self, range_table, init_tokens, constrain_func=None):
        raise NotImplementedError()

    def update(self, tokens, reward):
        raise NotImplementedError()

    def next_tokens(self, control_token=None):
        raise NotImplementedError()


class SAController(EvolutionaryController):
    """Simulated annealing: accept a worse candidate with probability
    exp(dreward / T), T decaying by reduce_rate each update — the
    reference's acceptance rule exactly."""

    def __init__(self, range_table=None, reduce_rate=0.85,
                 init_temperature=1024, max_try_number=300, seed=0):
        self._range_table = range_table
        self._reduce_rate = reduce_rate
        self._init_temperature = init_temperature
        self._max_try_number = max_try_number
        self._rng = np.random.RandomState(seed)
        self._constrain_func = None
        self._reward = -float("inf")
        self._tokens = None
        self._max_reward = -float("inf")
        self._best_tokens = None
        self._iter = 0

    @property
    def best_tokens(self):
        return self._best_tokens

    @property
    def max_reward(self):
        return self._max_reward

    def reset(self, range_table, init_tokens, constrain_func=None):
        self._range_table = list(range_table)
        self._constrain_func = constrain_func
        self._tokens = list(init_tokens)
        self._iter = 0
        # a fresh search must not inherit the previous objective's state
        self._reward = -float("inf")
        self._max_reward = -float("inf")
        self._best_tokens = None

    def update(self, tokens, reward):
        self._iter += 1
        temperature = self._init_temperature * \
            self._reduce_rate ** self._iter
        if reward > self._reward or self._rng.random_sample() <= math.exp(
                min((reward - self._reward) / max(temperature, 1e-12), 0)):
            self._reward = reward
            self._tokens = list(tokens)
        if reward > self._max_reward:
            self._max_reward = reward
            self._best_tokens = list(tokens)

    def next_tokens(self, control_token=None):
        tokens = list(control_token) if control_token else self._tokens
        # only positions with >1 option can mutate (a range of 1 pins a
        # fixed choice; mutating it would be randint(0) -> crash)
        mutable = [i for i, r in enumerate(self._range_table) if r > 1]
        if not mutable:
            return list(tokens)
        new_tokens = list(tokens)
        index = mutable[self._rng.randint(len(mutable))]
        new_tokens[index] = (
            new_tokens[index] +
            self._rng.randint(self._range_table[index] - 1) + 1) % \
            self._range_table[index]
        if self._constrain_func is None:
            return new_tokens
        for _ in range(self._max_try_number):
            if self._constrain_func(new_tokens):
                return new_tokens
            index = mutable[self._rng.randint(len(mutable))]
            new_tokens = list(tokens)
            new_tokens[index] = self._rng.randint(
                self._range_table[index])
        raise RuntimeError(
            "SAController: no constraint-satisfying candidate found in "
            "%d tries — the constrain_func may be infeasible around the "
            "current tokens %r" % (self._max_try_number, tokens))
