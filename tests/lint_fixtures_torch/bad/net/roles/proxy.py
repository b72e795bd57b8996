"""Proxy parking surface blocking-call violation (pump-surface rule)."""


class ProxyRole:
    def __init__(self, sock):
        self.sock = sock

    def _parking_pump(self):
        return self.sock.recv(4096)  # blocking recv on the pump thread

    def _on_client_message(self, frame):
        return frame

    def _on_switch_route(self, frame):
        return frame

    def _notify_switch(self, key):
        return key
