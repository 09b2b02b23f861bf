"""The deviceplugin/v1beta1 messages: ``deviceplugin.py``, a hand-written codec of ``deviceplugin.proto``."""
