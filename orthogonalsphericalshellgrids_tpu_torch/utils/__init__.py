from . import checkpoint, output, profiling, rotation, simulation
from .checkpoint import load_checkpoint, save_checkpoint
from .output import FieldTimeSeries, NetCDFWriter, OutputWriter, read_netcdf_series
from .rotation import rotation_angle, to_latlon_frame, to_native_frame
from .simulation import (Checkpointer, IterationInterval, NaNChecker, Simulation,
                         TimeInterval, TimeStepWizard, progress_callback)
