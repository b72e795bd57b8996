"""Clean proxy parking surface: nothing on it blocks."""


class ProxyRole:
    def __init__(self, sock):
        self.sock = sock

    def _parking_pump(self):
        return []

    def _on_client_message(self, frame):
        return frame

    def _on_switch_route(self, frame):
        return frame

    def _notify_switch(self, key):
        return key
