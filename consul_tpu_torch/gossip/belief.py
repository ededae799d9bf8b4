"""The belief byte's layout, ``msg:2 | conf:2 | age:4`` (reference
``consul_tpu/gossip/kernel.py``): the messages, the field shifts and
masks.  ``csrc/belief_merge.cuh``'s masks are the same fields, four bytes
to a word.  The round (``gossip/kernel.py``), the tail's wrappers and the
observers' counts (``gossip/observe.py``) read them from here."""

MSG_NONE = 0
MSG_SUSPECT = 1
MSG_DEAD = 2
MSG_REFUTE = 3   # alive@inc: refutations AND join announcements

_MSG_SHIFT = 6
_CONF_SHIFT = 4
_CONF_MASK = 0x3
_AGE_MASK = 0xF
_AGE_FRESH = 0xF  # sentinel: written by this round's probe marks, pre-aging
