"""KinectFusion pipeline (cupoch kinfu/)."""
from .kinfu import KinfuOption, KinfuPipeline, Pipeline

__all__ = ["KinfuOption", "KinfuPipeline", "Pipeline"]
