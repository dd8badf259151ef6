"""Traffic kind `frames`: the render CLI's progressive loop, one process on
one card (`drivers.Frames`); its frames feed the frames comparison."""
from portbench import faults
from portbench.drivers import Frames as DRIVER  # noqa: F401

COMPARES = "frames"
FAULTS = faults.FAULTS
plant = faults.frames_fault
