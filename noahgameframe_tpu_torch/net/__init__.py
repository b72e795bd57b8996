"""The wire format the persistence slice needs: the message codec of
``net/wire.py`` (``Message``, ``Ident``, the property and record lists,
``RoleLiteInfo``), its protocol constants and the retry policy.  The rest
of the JAX package's ``net/`` (transports, framing, roles) comes with the
serving edge."""
