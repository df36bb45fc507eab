"""slim.searcher (counterpart of paddle_tpu/contrib/slim/searcher/):
token-search controllers."""
from .controller import EvolutionaryController, SAController  # noqa: F401

__all__ = ["EvolutionaryController", "SAController"]
