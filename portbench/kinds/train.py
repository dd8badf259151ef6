"""Traffic kind `train`: `integrator/inverse.paired_step` as `recover_demo`
drives it, one process on one card (`drivers.Train`); its first steps feed
the training comparison."""
from portbench import faults
from portbench.drivers import Train as DRIVER  # noqa: F401

COMPARES = "train"
FAULTS = faults.TRAIN_FAULTS
plant = faults.train_fault
