from .ts import TSFileSource, synthetic_ts

__all__ = ["TSFileSource", "synthetic_ts"]
