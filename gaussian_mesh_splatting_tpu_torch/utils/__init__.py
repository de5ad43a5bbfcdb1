from .profiling import MetricsLogger, profiler_trace
from .general import safe_state
