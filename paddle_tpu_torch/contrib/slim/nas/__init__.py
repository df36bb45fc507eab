"""slim.nas (counterpart of paddle_tpu/contrib/slim/nas/): the LightNAS
search loop, in process (``LightNASStrategy``), and the controller
server and search agent that split it across processes over TCP."""
from .search_space import SearchSpace  # noqa: F401
from .light_nas_strategy import LightNASStrategy  # noqa: F401
from .controller_server import ControllerServer  # noqa: F401
from .search_agent import SearchAgent  # noqa: F401

__all__ = ["SearchSpace", "LightNASStrategy", "ControllerServer",
           "SearchAgent"]
