"""The host edge of the framework: NF framing and the MsgBase envelope
(``framing``, ``wire``), the pure-Python and native (``native/nfnet.cc``
over ctypes) transports, the net modules with their dispatch tables
(``module``), the metrics HTTP server (``http``), the SLG and shop wire
families, the batched serving edge's session table (``serving``) and the
game role (``roles``).  Counterpart of ``noahgameframe_tpu/net``; the
world, proxy, master and login roles, the cluster, chaos and failover
come with the cluster slice.  Submodules are imported by path."""
