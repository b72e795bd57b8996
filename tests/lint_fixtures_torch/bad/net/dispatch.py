"""dispatch-handler violations: registrations naming absent handlers."""


class LobbyRole:
    def __init__(self, server):
        self.server = server
        self.server.on(101, self._on_login)  # no such method
        self.server.on_any(self._tap)  # no such method

    def _on_logout(self, conn_id, frame):
        return frame
