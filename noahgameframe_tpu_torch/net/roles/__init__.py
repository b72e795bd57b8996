"""Server roles: the shared scaffolding (``base``) and the game role, the
kernel-backed world server (``game``).  The world, proxy, master and login
roles and the localhost cluster come with the cluster slice."""

from .base import RoleConfig, ServerRole, load_server_xml  # noqa: F401
from .game import GameRole, Session  # noqa: F401
