from .profiling import MetricsLogger
