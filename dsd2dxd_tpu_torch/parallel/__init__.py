"""Multi-device conversion: one stream's overlap-save tiles over a list of
devices (``sharded.py``). File-level parallelism is the CLI's round-robin
(``cli/dsd2dxd.py``, ``utils/device.batch_devices``)."""
