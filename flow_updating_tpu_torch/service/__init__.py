"""The streaming service of the port (counterpart of
``flow_updating_tpu/service``).

Ported: the membership primitives (:mod:`.membership`) that the engine's
fault injection uses.  The ``ServiceEngine`` itself, its events and its
checkpoints are the ROADMAP item A11.
"""
