# Copy of watsor_tpu/runtime/__init__.py; only its imports differ.
from watsor_tpu_torch.runtime.frames import (
          State, CountDownLatch, StateLatch, Frame, FrameBuffer,
          DETECTION_DTYPE, MAX_DETECTIONS, MAX_ZONES,
      )
from watsor_tpu_torch.runtime.channel import BalancedQueue, Publish
from watsor_tpu_torch.runtime.meters import FramesPerSecond, InferenceTime, RateLimiter
from watsor_tpu_torch.runtime.tasks import Task, Stub, Read, ReadFrameBuffer, ReadPublish, \
    ReadDetectPublish, Work, WorkPublish, WorkInOutPublish, WorkPassthroughPublish, Payload
from watsor_tpu_torch.runtime.watchdog import WatchDog

__all__ = [
    "State", "CountDownLatch", "StateLatch", "Frame", "FrameBuffer",
    "DETECTION_DTYPE", "MAX_DETECTIONS", "MAX_ZONES",
    "BalancedQueue", "Publish",
    "FramesPerSecond", "InferenceTime", "RateLimiter",
    "Task", "Stub", "Read", "ReadFrameBuffer", "ReadPublish",
    "ReadDetectPublish", "Work", "WorkPublish", "WorkInOutPublish",
    "WorkPassthroughPublish", "Payload", "WatchDog",
]
