from .common import c2w, degrees, radians
from .log import LOGD, LOGE, LOGI, LOGW, LogLevel, set_log_level
from .timing import Timer, device_timer, trace


def zfill(n: int, width: int = 5) -> str:
    """Zero-padded numbering (reference: include/vacancy/common.h:70-82)."""
    return str(n).zfill(width)
