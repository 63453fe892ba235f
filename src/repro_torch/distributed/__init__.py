"""The distributed engine's exchange: `collectives` (the process group's
collectives on `torch.distributed`, with host staging for ranks that
share one card under gloo) and `wire` (the delta-exchange codecs). The
engine itself is `core/engines/distributed.py`."""
