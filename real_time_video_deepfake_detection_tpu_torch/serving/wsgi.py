"""Minimal WSGI micro-framework (stdlib only).

The port's own copy of real_time_video_deepfake_detection_tpu/serving/
wsgi.py. The reference serves through Flask (backend_server.py); Flask is
not part of the dependency set, so the HTTP surface is implemented directly
on WSGI: routing, JSON responses, multipart/form-data parsing, permissive
CORS, and an in-process test client mirroring the reference test suite's
`app.test_client()` technique (reference tests/test_functional.py:356-424).
"""

from __future__ import annotations

import io
import json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET")
        self.path = environ.get("PATH_INFO", "/")
        self.content_type = environ.get("CONTENT_TYPE", "")
        try:
            # clamp: a negative Content-Length would turn read() into
            # read-to-EOF, blocking a keep-alive socket until the client
            # hangs up — treat it like the unparsable-header case instead
            length = max(0, int(environ.get("CONTENT_LENGTH") or 0))
        except ValueError:
            length = 0
        self.body = environ["wsgi.input"].read(length) if length else b""
        self.files: Dict[str, bytes] = {}
        self.form: Dict[str, str] = {}
        if self.content_type.startswith("multipart/form-data"):
            self._parse_multipart()

    def _parse_multipart(self) -> None:
        """RFC 2046 §5.1.1 parsing with exact payload bytes: each part ends
        at the CRLF that BELONGS TO the next boundary line, so payloads whose
        own trailing bytes are \\r or \\n survive intact (a naive
        strip(b"\\r\\n") corrupts e.g. BMP pixel data ending in 0x0A/0x0D).
        Bare-LF generators are tolerated like werkzeug does."""
        # Quoted form first: RFC 2046 bchars include ',' and ';' inside a
        # quoted boundary, so matching [^";,]+ would truncate a legal
        # boundary="xy,z" to 'xy' and the parts would never be found.
        m = re.search(r'boundary="([^"]+)"', self.content_type)
        if not m:
            m = re.search(r'boundary=([^";\s]+)', self.content_type)
        if not m:
            return
        delim = b"--" + m.group(1).encode()
        body = self.body
        pos = body.find(delim)
        while pos != -1:
            pos += len(delim)
            if body[pos:pos + 2] == b"--":   # closing delimiter
                break
            if body[pos:pos + 2] == b"\r\n":
                pos += 2
            elif body[pos:pos + 1] == b"\n":
                pos += 1
            nxt = body.find(b"\r\n" + delim, pos)
            if nxt == -1:
                nxt = body.find(b"\n" + delim, pos)
            if nxt == -1:
                break
            part = body[pos:nxt]
            pos = body.find(delim, nxt)
            if b"\r\n\r\n" in part:
                head, _, payload = part.partition(b"\r\n\r\n")
            elif b"\n\n" in part:
                head, _, payload = part.partition(b"\n\n")
            else:
                continue
            head_text = head.decode("utf-8", "replace")
            name_m = re.search(r'name="([^"]*)"', head_text)
            if not name_m:
                continue
            name = name_m.group(1)
            if 'filename="' in head_text:
                self.files[name] = payload
            else:
                self.form[name] = payload.decode("utf-8", "replace")


class Response:
    def __init__(self, body: bytes, status: int = 200,
                 content_type: str = "application/json",
                 headers: Optional[List[Tuple[str, str]]] = None):
        self.body = body
        self.status = status
        self.headers = [("Content-Type", content_type),
                        ("Content-Length", str(len(body)))] + (headers or [])

    def get_json(self):
        return json.loads(self.body.decode("utf-8"))

    @property
    def status_code(self) -> int:
        return self.status

    @property
    def data(self) -> bytes:
        return self.body


def jsonify(obj: Any, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode("utf-8"), status)


_STATUS_TEXT = {200: "OK", 400: "BAD REQUEST", 404: "NOT FOUND",
                405: "METHOD NOT ALLOWED", 429: "TOO MANY REQUESTS",
                500: "INTERNAL SERVER ERROR"}

_CORS_HEADERS = [
    ("Access-Control-Allow-Origin", "*"),
    ("Access-Control-Allow-Methods", "GET, POST, OPTIONS"),
    ("Access-Control-Allow-Headers", "Content-Type"),
]


class App:
    """Route table + WSGI callable (+ CORS like backend_server.py:45-53)."""

    def __init__(self):
        self._routes: Dict[Tuple[str, str], Callable[[Request], Response]] = {}

    def route(self, path: str, methods=("GET",)):
        def deco(fn):
            for m in methods:
                self._routes[(path, m.upper())] = fn
            return fn
        return deco

    def dispatch(self, request: Request) -> Response:
        if request.method == "OPTIONS":
            return Response(b"", 200, "text/plain")
        handler = self._routes.get((request.path, request.method))
        if handler is None:
            if any(p == request.path for (p, _) in self._routes):
                return jsonify({"error": "Method not allowed"}, 405)
            return jsonify({"error": "Not found"}, 404)
        try:
            return handler(request)
        except Exception as e:  # blanket 500 (backend_server.py:235-238)
            return jsonify({"error": str(e)}, 500)

    def __call__(self, environ, start_response):
        resp = self.dispatch(Request(environ))
        status_line = f"{resp.status} {_STATUS_TEXT.get(resp.status, '')}".strip()
        start_response(status_line, resp.headers + _CORS_HEADERS)
        return [resp.body]

    def test_client(self) -> "TestClient":
        return TestClient(self)


class TestClient:
    """In-process client (reference tests call Flask's test_client the same
    way — tests/test_functional.py:359)."""

    def __init__(self, app: App):
        self.app = app

    def _request(self, method: str, path: str, data: bytes = b"",
                 content_type: str = "") -> Response:
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": path,
            "CONTENT_TYPE": content_type,
            "CONTENT_LENGTH": str(len(data)),
            "wsgi.input": io.BytesIO(data),
        }
        return self.app.dispatch(Request(environ))

    def get(self, path: str) -> Response:
        return self._request("GET", path)

    def post(self, path: str, data: Optional[dict] = None,
             content_type: str = "") -> Response:
        """`data` may carry {'frame': (BytesIO, filename)} like the Flask
        client convention used by the reference tests."""
        if data is None:
            return self._request("POST", path, b"", content_type or "application/json")
        boundary = "testboundary1234567890"
        out = io.BytesIO()
        for name, value in data.items():
            out.write(f"--{boundary}\r\n".encode())
            if isinstance(value, tuple):
                fileobj, filename = value
                payload = fileobj.read() if hasattr(fileobj, "read") else fileobj
                out.write(
                    f'Content-Disposition: form-data; name="{name}"; '
                    f'filename="{filename}"\r\n\r\n'.encode())
                out.write(payload if isinstance(payload, bytes) else bytes(payload))
            else:
                out.write(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
                out.write(str(value).encode())
            out.write(b"\r\n")
        out.write(f"--{boundary}--\r\n".encode())
        return self._request("POST", path, out.getvalue(),
                             f"multipart/form-data; boundary={boundary}")
