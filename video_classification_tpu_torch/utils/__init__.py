from .chapath import ChaPath
from .labels import Labels, get_labels, parse_label_lines, write_labels
from .logging import MetricsLogger
from .profiling import StepTimer, trace

__all__ = ["ChaPath", "Labels", "MetricsLogger", "StepTimer", "get_labels",
           "parse_label_lines", "trace", "write_labels"]
