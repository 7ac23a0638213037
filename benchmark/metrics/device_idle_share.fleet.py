"""The device's idle share of a fleet tick, read as
``device_idle_share.batch`` reads the batched tick's: 1 - the device's busy
time a tick in the profiled ticks over the host-clock time a tick in the
window of the same run."""

import harness

read = harness.metric_reader(harness.ROOT, "device_idle_share.batch").read
