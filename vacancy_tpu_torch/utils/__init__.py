from .log import LOGD, LOGE, LOGI, LOGW, LogLevel, set_log_level
