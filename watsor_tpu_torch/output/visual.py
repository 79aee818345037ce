# Copy of watsor_tpu/output/visual.py: imports and paths adapted.
"""Visual-effects stage: copies each published frame from the camera's
input ring to its output ring, applying the render-effect chain, and fans
the rendered frame out to the encoder and HTTP subscribers.

Reference contract (upstream watsor/output/video.py:10-35 +
work.py:69-114): effects only run while someone is subscribed — with no
encoder and no viewers the input frame is released untouched, so rendering
costs nothing when nobody is watching.
"""

from watsor_tpu_torch.runtime.meters import FramesPerSecond
from watsor_tpu_torch.runtime.tasks import WorkInOutPublish


class VisualEffects(WorkInOutPublish):

    def __init__(self, name, frame_queue, frame_buffer_in, frame_buffer_out,
                 effects, stop_event=None):
        self._effects = list(effects)
        self.fps = FramesPerSecond()
        super().__init__(name, frame_queue, frame_buffer_in,
                         frame_buffer_out, stop_event)

    def _incoming_frame(self, frame_in, frame_out):
        for effect in self._effects:
            effect.apply(frame_in, frame_out)
        frame_out.stamp(frame_in.epoch)
        self.fps(True)
