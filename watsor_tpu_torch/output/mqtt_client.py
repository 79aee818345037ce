# Copy of watsor_tpu/output/mqtt_client.py: imports and paths adapted.
"""Minimal MQTT 3.1.1 client (clean-room, stdlib sockets only).

The reference depends on paho-mqtt (upstream watsor/output/mqtt.py);
this embedding framework ships its own small client so the MQTT integration
has zero external dependencies. Supports what the HomeAssistant integration
needs: CONNECT with auth + last-will, QoS 0 PUBLISH with retain, SUBSCRIBE,
keep-alive pings, and a reader thread dispatching messages to a callback.
"""

import socket
import struct
import threading
import time

# Control packet types (MQTT 3.1.1 §2.2.1)
CONNECT, CONNACK = 0x10, 0x20
PUBLISH, SUBSCRIBE, SUBACK = 0x30, 0x80, 0x90
PINGREQ, PINGRESP = 0xC0, 0xD0
DISCONNECT = 0xE0


def _encode_string(s):
    data = s.encode('utf-8')
    return struct.pack('>H', len(data)) + data


def _encode_length(n):
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


class MqttError(IOError):
    pass


class _IdleTimeout(Exception):
    """recv timed out BEFORE any byte of a packet was consumed — the
    stream is still in sync, the broker is merely quiet."""


class MqttClient:
    """Blocking connect; background reader thread; thread-safe publish."""

    def __init__(self, client_id, host, port=1883, username=None,
                 password=None, keepalive=60, will=None,
                 on_message=None, on_disconnect=None):
        self._client_id = client_id
        self._addr = (host, port)
        self._auth = (username, password)
        self._keepalive = keepalive
        self._will = will  # (topic, payload, retain)
        self.on_message = on_message
        self.on_disconnect = on_disconnect
        self._sock = None
        self._write_lock = threading.Lock()
        self._reader = None
        self._pinger = None
        self._connected = threading.Event()
        self._stopping = False
        self._packet_id = 0
        self._last_rx = time.monotonic()

    # -- wire helpers ------------------------------------------------------

    def _send(self, packet):
        with self._write_lock:
            sock = self._sock          # the reader thread's _teardown may
            if sock is None:           # null the attribute concurrently;
                raise MqttError('not connected')   # a local read keeps
            sock.sendall(packet)       # the failure an OSError, not an
                                       # AttributeError nothing catches

    def _recv_exact(self, n):
        data = b''
        while len(data) < n:
            chunk = self._sock.recv(n - len(data))
            if not chunk:
                raise MqttError('connection closed')
            data += chunk
        return data

    def _recv_packet(self):
        try:
            header = self._recv_exact(1)[0]
        except socket.timeout:
            # no bytes consumed: safe to resume later; a timeout anywhere
            # past this point means a torn packet (resync impossible) and
            # propagates as fatal
            raise _IdleTimeout()
        length = 0
        shift = 0
        while True:
            byte = self._recv_exact(1)[0]
            length |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        payload = self._recv_exact(length) if length else b''
        return header, payload

    # -- lifecycle ---------------------------------------------------------

    def connect(self, timeout=10):
        self._stopping = False
        self._sock = socket.create_connection(self._addr, timeout=timeout)
        self._sock.settimeout(timeout)

        flags = 0x02  # clean session
        payload = _encode_string(self._client_id)
        if self._will:
            topic, message, retain = self._will
            flags |= 0x04 | (0x20 if retain else 0)
            payload += _encode_string(topic)
            payload += struct.pack('>H', len(message)) + message
        username, password = self._auth
        if username is not None:
            flags |= 0x80
            payload += _encode_string(username)
            if password is not None:
                flags |= 0x40
                payload += _encode_string(password)

        var_header = _encode_string('MQTT') + bytes([4, flags]) + \
            struct.pack('>H', self._keepalive)
        body = var_header + payload
        self._send(bytes([CONNECT]) + _encode_length(len(body)) + body)

        header, data = self._recv_packet()
        if header & 0xF0 != CONNACK or len(data) < 2 or data[1] != 0:
            code = data[1] if len(data) >= 2 else -1
            raise MqttError('CONNACK refused (code {})'.format(code))

        self._sock.settimeout(max(self._keepalive * 1.5, 5))
        self._last_rx = time.monotonic()
        self._connected.set()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=self._client_id + '-mqtt-read')
        self._reader.start()
        self._pinger = threading.Thread(target=self._ping_loop, daemon=True,
                                        name=self._client_id + '-mqtt-ping')
        self._pinger.start()

    def disconnect(self):
        self._stopping = True
        try:
            self._send(bytes([DISCONNECT, 0]))
        except Exception:
            pass
        self._teardown()

    def _teardown(self):
        self._connected.clear()
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                # shutdown first: unblocks a reader thread parked in recv
                # (a bare close is deferred while recv holds the fd)
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    @property
    def connected(self):
        return self._connected.is_set()

    # -- loops -------------------------------------------------------------

    def _read_loop(self):
        try:
            while not self._stopping:
                try:
                    header, data = self._recv_packet()
                except _IdleTimeout:
                    # a quiet broker is not a dead broker — but a broker
                    # that answered nothing (not even PINGRESP) for two
                    # keepalive periods is gone (half-open TCP): tear
                    # down so the owner reconnects with backoff
                    if time.monotonic() - self._last_rx > \
                            max(self._keepalive * 2.0, 10.0):
                        raise MqttError('broker unresponsive')
                    continue
                self._last_rx = time.monotonic()
                packet_type = header & 0xF0
                if packet_type == PUBLISH:
                    self._handle_publish(header, data)
                # PINGRESP/SUBACK need no action at QoS 0
        except Exception:
            if not self._stopping:
                self._teardown()
                if self.on_disconnect:
                    self.on_disconnect()

    def _ping_loop(self):
        interval = max(self._keepalive - 5, 5)
        while not self._stopping and self._connected.is_set():
            time.sleep(interval)
            try:
                self._send(bytes([PINGREQ, 0]))
            except Exception:
                return

    def _handle_publish(self, header, data):
        qos = (header >> 1) & 0x03
        topic_len = struct.unpack('>H', data[:2])[0]
        topic = data[2:2 + topic_len].decode('utf-8')
        offset = 2 + topic_len
        if qos > 0:
            packet_id = struct.unpack('>H', data[offset:offset + 2])[0]
            offset += 2
            # acknowledge QoS 1 so brokers don't redeliver forever
            self._send(bytes([0x40, 2]) + struct.pack('>H', packet_id))
        payload = data[offset:]
        if self.on_message:
            try:
                self.on_message(topic, payload)
            except Exception:
                pass

    # -- operations --------------------------------------------------------

    def publish(self, topic, payload=b'', retain=False):
        if isinstance(payload, str):
            payload = payload.encode('utf-8')
        header = PUBLISH | (0x01 if retain else 0)
        body = _encode_string(topic) + payload
        self._send(bytes([header]) + _encode_length(len(body)) + body)

    def subscribe(self, topic_filter):
        self._packet_id = self._packet_id % 0xFFFF + 1
        body = struct.pack('>H', self._packet_id) + \
            _encode_string(topic_filter) + b'\x00'
        self._send(bytes([SUBSCRIBE | 0x02]) + _encode_length(len(body)) +
                   body)
