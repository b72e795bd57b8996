"""Server roles: the shared scaffolding (``base``), the kernel-backed game
role (``game``), the world, proxy, master and login roles, and the
localhost five-role cluster (``cluster.LocalCluster``).  Counterpart of
``noahgameframe_tpu/net/roles``."""

from .base import RoleConfig, ServerRole, load_server_xml  # noqa: F401
from .cluster import LocalCluster  # noqa: F401
from .game import GameRole, Session  # noqa: F401
from .login import LoginRole  # noqa: F401
from .master import MasterRole  # noqa: F401
from .proxy import ProxyRole  # noqa: F401
from .world import WorldRole  # noqa: F401
