"""Data: the synthetic dataset, the host-fed ``BatchLoader`` and the
card-resident ``DeviceStore``."""
