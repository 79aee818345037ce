# Copy of watsor_tpu/testing/broker.py: paths adapted.
"""A miniature in-process MQTT 3.1.1 broker for tests.

Enough protocol to host the framework's own client (CONNECT/CONNACK,
PUBLISH routing, SUBSCRIBE/SUBACK, PINGREQ/PINGRESP, DISCONNECT, LWT on
abnormal drop). The reference tests MQTT against a MagicMock of paho
(upstream watsor/test/test_output.py); a real socket round trip
through a mini broker covers strictly more.
"""

import socket
import struct
import threading


def _read_exact(conn, n):
    data = b''
    while len(data) < n:
        chunk = conn.recv(n - len(data))
        if not chunk:
            raise ConnectionError('closed')
        data += chunk
    return data


def _read_packet(conn):
    header = _read_exact(conn, 1)[0]
    length = 0
    shift = 0
    while True:
        byte = _read_exact(conn, 1)[0]
        length |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return header, _read_exact(conn, length) if length else b''


def _encode_length(n):
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _string(data, offset):
    n = struct.unpack('>H', data[offset:offset + 2])[0]
    return data[offset + 2:offset + 2 + n], offset + 2 + n


def _topic_matches(pattern, topic):
    p_parts = pattern.split('/')
    t_parts = topic.split('/')
    for i, p in enumerate(p_parts):
        if p == '#':
            return True
        if i >= len(t_parts):
            return False
        if p != '+' and p != t_parts[i]:
            return False
    return len(p_parts) == len(t_parts)


class MiniBroker:
    """records: list of (topic, payload, retain); publish() injects a
    message toward connected subscribers."""

    def __init__(self, port=0):
        self._server = socket.socket()
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(('127.0.0.1', port))
        self._server.listen(4)
        self.port = self._server.getsockname()[1]
        self.records = []
        self.received = threading.Condition()
        self._clients = []      # (conn, subscriptions, will, lock)
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def close(self):
        self._stop = True
        try:
            # wake the accept thread (a bare close leaves it blocked, which
            # keeps the kernel listen socket alive and the port unbindable)
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server.close()
        except OSError:
            pass
        # shutdown (not just close) so serve threads blocked in recv release
        # their fds — otherwise the port can't be rebound by a restart
        self.drop_clients()

    def drop_clients(self):
        """Forcibly close every client connection (simulates a broker
        crash/restart from the clients' point of view)."""
        for conn, _, _, _ in list(self._clients):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def wait_for(self, predicate, timeout=5):
        with self.received:
            return self.received.wait_for(
                lambda: any(predicate(t, p) for t, p, _ in self.records),
                timeout)

    def wait_subscribed(self, topic, timeout=5):
        """Block until some connected client's subscriptions match topic."""
        deadline = None
        import time
        deadline = time.time() + timeout
        while time.time() < deadline:
            for _, subs, _, _ in list(self._clients):
                if any(_topic_matches(s, topic) for s in subs):
                    return True
            time.sleep(0.02)
        return False

    def publish(self, topic, payload):
        if isinstance(payload, str):
            payload = payload.encode()
        packet = bytes([0x30]) + _encode_length(
            2 + len(topic) + len(payload)) + \
            struct.pack('>H', len(topic)) + topic.encode() + payload
        for conn, subs, _, lock in list(self._clients):
            if any(_topic_matches(s, topic) for s in subs):
                with lock:
                    try:
                        conn.sendall(packet)
                    except OSError:
                        pass

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _record(self, topic, payload, retain):
        with self.received:
            self.records.append((topic, payload, retain))
            self.received.notify_all()

    def _serve(self, conn):
        subs = set()
        will = None
        lock = threading.Lock()
        entry = (conn, subs, None, lock)
        try:
            header, data = _read_packet(conn)
            assert header & 0xF0 == 0x10, 'expected CONNECT'
            # variable header: protocol name + level + flags + keepalive
            _, offset = _string(data, 0)
            flags = data[offset + 1]
            offset += 4
            _, offset = _string(data, offset)  # client id
            if flags & 0x04:                   # will
                will_topic, offset = _string(data, offset)
                will_payload, offset = _string(data, offset)
                will = (will_topic.decode(), will_payload,
                        bool(flags & 0x20))
            entry = (conn, subs, will, lock)
            self._clients.append(entry)
            with lock:
                conn.sendall(bytes([0x20, 2, 0, 0]))  # CONNACK accepted

            while True:
                header, data = _read_packet(conn)
                packet_type = header & 0xF0
                if packet_type == 0x30:       # PUBLISH
                    topic, offset = _string(data, 0)
                    qos = (header >> 1) & 3
                    if qos:
                        offset += 2
                    self._record(topic.decode(), data[offset:],
                                 bool(header & 1))
                elif packet_type == 0x80:     # SUBSCRIBE
                    packet_id = data[:2]
                    offset = 2
                    codes = b''
                    while offset < len(data):
                        topic_filter, offset = _string(data, offset)
                        offset += 1           # requested qos
                        subs.add(topic_filter.decode())
                        codes += b'\x00'
                    with lock:
                        conn.sendall(bytes([0x90]) +
                                     _encode_length(2 + len(codes)) +
                                     packet_id + codes)
                elif packet_type == 0xC0:     # PINGREQ
                    with lock:
                        conn.sendall(bytes([0xD0, 0]))
                elif packet_type == 0xE0:     # DISCONNECT
                    will = None               # clean close: no LWT
                    break
        except (ConnectionError, AssertionError, OSError):
            pass
        finally:
            if entry in self._clients:
                self._clients.remove(entry)
            if will is not None:
                self._record(will[0], will[1], will[2])
            try:
                conn.close()
            except OSError:
                pass
