"""What a configuration's task does in the window and how its outputs are
compared; ``tasks/<task>.py``, named by the configuration's ``task``."""
