# Copy of watsor_tpu/output/mqtt.py: imports and paths adapted.
"""MQTT / HomeAssistant reporting and remote camera control.

Topic tree and command language match the reference bit-for-bit
(upstream watsor/output/mqtt.py:31-286, README topic docs):

    watsor/cameras/{camera}/available            online|offline (retained, LWT)
    watsor/cameras/{camera}/state                ON|OFF (decoder commanded)
    watsor/cameras/{camera}/command       <-     ON | OFF | FPS = n | details = on/off
    watsor/cameras/{camera}/sensor               {"fps_in":..,"fps_out":..,"buffer":..}
    watsor/cameras/{camera}/detection/{class}/state    ON|OFF (OFF after 10 s quiet)
    watsor/cameras/{camera}/detection/{class}/details  {"t":..,"d":[{"c":..,"b":..,"z":..}]}

Cross-component control re-designed for the threaded runtime: 'OFF' sets the
decoder task's stop event (the watchdog then leaves it down), 'ON' clears it
(the watchdog resurrects it); 'FPS = n' drives the decoder's shared token
bucket — the same observable semantics as the reference's shared
Event/RateLimiter across its process boundary (mqtt.py:143-185).

Session resilience: the reference relies on paho's automatic reconnect
(upstream watsor/output/mqtt.py:98-112 — LWT then resumed
publishing); here a broker drop flags the session and the stage's own spin
re-connects with exponential backoff, re-announcing availability,
re-subscribing commands and re-emitting every retained topic.
"""

import json
import re
from time import monotonic, time

from watsor_tpu_torch.config.coco import get_coco_class
from watsor_tpu_torch.output.mqtt_client import MqttClient, MqttError
from watsor_tpu_torch.runtime.meters import FramesPerSecond, LatencyMeter
from watsor_tpu_torch.runtime.tasks import WorkPublish

STATE_OFF_DELAY_SECONDS = 10.0
_FPS_COMMAND = re.compile(r'^\s*FPS\s*=\s*(\d+)\s*$', re.IGNORECASE)
_DETAILS_COMMAND = re.compile(r'^\s*details\s*=\s*(on|off)\s*$', re.IGNORECASE)


class MQTT(WorkPublish):
    """Per-camera MQTT reporter/controller, consuming sieved frames."""

    def __init__(self, name, camera_name, frame_queue, frame_buffer,
                 mqtt_config, class_names, decoder, stop_event=None,
                 client_factory=MqttClient, topic_root='watsor/cameras'):
        self._camera = camera_name
        self._class_names = list(class_names)
        self._decoder = decoder
        self._prefix = '{}/{}'.format(topic_root, camera_name)
        self._details_enabled = False
        self._last_sensor = None
        self._last_camera_state = None
        # class -> last time a detection of that class was seen
        self._last_seen = {c: 0.0 for c in class_names}
        self._reported_on = {c: False for c in class_names}
        self.fps = FramesPerSecond()
        # frame capture -> MQTT report, sliding percentiles (/metrics)
        self.latency = LatencyMeter()
        # reconnect backoff state (session resilience)
        self._next_attempt = 0.0
        self._backoff = 1.0

        self._client = client_factory(
            client_id='watsor-' + camera_name,
            host=mqtt_config['host'],
            port=mqtt_config.get('port', 1883),
            username=mqtt_config.get('username'),
            password=mqtt_config.get('password'),
            will=(self._prefix + '/available', b'offline', True),
            on_message=self._on_message,
            on_disconnect=self._on_disconnect,
        )
        super().__init__(name, frame_queue, frame_buffer, stop_event)

    # -- lifecycle ---------------------------------------------------------

    def _on_start(self):
        self._next_attempt = 0.0
        self._backoff = 1.0
        self._ensure_connected()

    def _on_disconnect(self):
        # called from the client's reader thread on socket loss; the spin
        # thread performs the actual reconnect (no cross-thread connects)
        self._logger.warning('MQTT connection lost; will reconnect')
        self._next_attempt = monotonic() + 1.0
        self._backoff = 1.0

    def _ensure_connected(self):
        """Connect (or reconnect with backoff) and re-announce the session:
        availability, command subscription and every retained topic."""
        if self._client.connected:
            return True
        now = monotonic()
        if now < self._next_attempt:
            return False
        try:
            self._client.connect()
        except (MqttError, OSError):
            self._next_attempt = now + self._backoff
            if self._backoff == 1.0:   # log the first failure, then quiet
                self._logger.exception('MQTT connect failed (retrying, '
                                       'backoff up to 30 s)')
            self._backoff = min(self._backoff * 2, 30.0)
            return False
        self._backoff = 1.0
        try:
            self._client.publish(self._prefix + '/available', 'online',
                                 retain=True)
            self._client.subscribe(self._prefix + '/command')
            # re-emit retained state so the broker's view is fresh even if
            # it lost its retained store in a restart
            for class_name, on in self._reported_on.items():
                topic = '{}/detection/{}/state'.format(self._prefix,
                                                       class_name)
                self._client.publish(topic, 'ON' if on else 'OFF',
                                     retain=True)
            self._last_sensor = None
            self._last_camera_state = None
            self._report_sensor()
            self._report_camera_state()
        except (MqttError, OSError):
            # half-announced session (e.g. no command subscription) is
            # worse than none: drop it so the next tick redoes the whole
            # connect+announce sequence
            try:
                self._client.disconnect()
            except (MqttError, OSError):
                pass
            self._next_attempt = monotonic() + self._backoff
            self._backoff = min(self._backoff * 2, 30.0)
            return False
        self._logger.info('MQTT connected to %s', self._prefix)
        return True

    def _on_stop(self):
        try:
            if self._client.connected:
                self._client.publish(self._prefix + '/available', 'offline',
                                     retain=True)
                self._client.disconnect()
        except (MqttError, OSError):
            pass

    # -- commands ----------------------------------------------------------

    def _on_message(self, topic, payload):
        text = payload.decode('utf-8', errors='replace')
        if text.strip().upper() == 'ON':
            self._decoder.stop_event.clear()     # watchdog restarts it
        elif text.strip().upper() == 'OFF':
            self._decoder.terminate()
        else:
            m = _FPS_COMMAND.match(text)
            if m:
                self._decoder.rate_limiter.limit_rate(int(m.group(1)))
                return
            m = _DETAILS_COMMAND.match(text)
            if m:
                self._details_enabled = m.group(1).lower() == 'on'

    # -- reporting ---------------------------------------------------------

    def _new_frame(self, frame, payload):
        try:
            detections = frame.detections_view().copy()
            epoch = frame.epoch
        finally:
            frame.latch.next()
        self.fps(True)
        self.latency((time() - epoch) * 1000.0)
        if not self._ensure_connected():
            return
        now = time()
        try:
            self._report_states(detections, now)
            if self._details_enabled and len(detections):
                self._report_details(detections, epoch)
            self._report_sensor()
            self._report_camera_state()
        except (MqttError, OSError):
            # disconnect raced past the gate: don't kill the spin — the
            # next tick reconnects with backoff
            self._on_disconnect()

    def _no_frame(self):
        # idle tick: detections may have gone quiet; keep topics fresh
        if not self._ensure_connected():
            return
        try:
            self._report_states([], time())
            self._report_sensor()
            self._report_camera_state()
        except (MqttError, OSError):
            self._on_disconnect()

    def _report_states(self, detections, now):
        seen_now = set()
        for det in detections:
            style = get_coco_class(int(det['label']))
            seen_now.add(style.label)
        for class_name in self._class_names:
            topic = '{}/detection/{}/state'.format(self._prefix, class_name)
            if class_name in seen_now:
                self._last_seen[class_name] = now
                if not self._reported_on[class_name]:
                    self._reported_on[class_name] = True
                    self._client.publish(topic, 'ON', retain=True)
            elif self._reported_on[class_name] and \
                    now - self._last_seen[class_name] > STATE_OFF_DELAY_SECONDS:
                self._reported_on[class_name] = False
                self._client.publish(topic, 'OFF', retain=True)

    def _report_details(self, detections, epoch):
        from datetime import datetime
        by_class = {}
        for det in detections:
            style = get_coco_class(int(det['label']))
            # wire format is the reference's exactly
            # (upstream watsor/output/mqtt.py:213-221): 'b' is
            # [x_min, y_min, x_max, y_max] (the header stores y-major),
            # 't' is an ISO timestamp
            y0, x0, y1, x1 = (int(v) for v in det['bbox'])
            entry = {
                'c': round(float(det['confidence']) * 100.0, 1),
                'b': [x0, y0, x1, y1],
            }
            n = int(det['num_zones'])
            if n:
                entry['z'] = [int(z) for z in det['zones'][:n]]
            by_class.setdefault(style.label, []).append(entry)
        stamp = datetime.fromtimestamp(epoch).isoformat()
        for class_name, entries in by_class.items():
            topic = '{}/detection/{}/details'.format(self._prefix, class_name)
            self._client.publish(topic, json.dumps(
                {'t': stamp, 'd': entries}, separators=(',', ':')))

    def _report_sensor(self):
        sensor = {
            'fps_in': round(self._decoder.fps.fps, 1),
            'fps_out': round(self.fps.fps, 1),
            'buffer': round(self.frame_buffer.fullness * 100),
        }
        if sensor != self._last_sensor:
            self._last_sensor = sensor
            self._client.publish(self._prefix + '/sensor',
                                 json.dumps(sensor, separators=(',', ':')),
                                 retain=True)

    def _report_camera_state(self):
        # exact reference payloads and rule: 'OFF' iff the camera was
        # commanded off (upstream watsor/output/mqtt.py:280-286)
        state = 'OFF' if self._decoder.is_shutdown() else 'ON'
        if state != self._last_camera_state:
            self._last_camera_state = state
            self._client.publish(self._prefix + '/state', state, retain=True)
