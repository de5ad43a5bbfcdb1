from .profiling import MetricsLogger, StepTimer, profiler_trace
from .general import safe_state
