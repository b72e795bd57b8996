"""Clean dispatch: every registration form with a resolvable handler."""


def _echo(conn_id, frame):
    return frame


class LobbyRole:
    def __init__(self, server):
        self.server = server
        self.server.on(101, self._on_login)  # method
        self.server.on(102, _echo)  # module function
        self.server.on(103, lambda c, f: f)  # lambda
        self.server.on_any(self._tap)
        self.server.on_socket_event(self._on_socket)

    def on(self, msg_id, fn):
        self.server.on(msg_id, fn)  # parameter forwarding (wrapper)

    def _on_login(self, conn_id, frame):
        return frame

    def _tap(self, conn_id, frame):
        return frame

    def _on_socket(self, event):
        return event
