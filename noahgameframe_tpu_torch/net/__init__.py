"""The host edge of the framework: NF framing and the MsgBase envelope
(``framing``, ``wire``), the pure-Python and native (``native/nfnet.cc``
over ctypes) transports, the net modules with their dispatch tables
(``module``), the metrics HTTP server (``http``), the SLG and shop wire
families, the batched serving edge's session table (``serving``), deterministic fault injection
(``chaos``), supervised session failover (``failover``) and the five
server roles with the localhost cluster (``roles``).  Counterpart of
``noahgameframe_tpu/net``.  Submodules are imported by path."""
