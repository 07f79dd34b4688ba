"""HTTP serving on the stdlib ``ThreadingHTTPServer``: the JAX package's
REST surface (its ``serve/server.py`` stdlib handler), with /generate/stream
as a chunked ``audio/L16`` body. A request body that fails its schema
answers 422; a service KeyError or ValueError 400 (404 where a route says).

``run_server(cfg, tts, background=True)`` serves from a daemon thread and
returns the server (``server_address`` holds the bound port; port 0 takes
an ephemeral one). The JAX package's FastAPI app is not ported: it needs
fastapi and uvicorn, which the port does not require (ROADMAP).
"""

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from .config import ServerConfig, get_config
from .schemas import EmotionCreateRequest, EmotionUpdateRequest, TTSRequest, ValidationError
from .service import TTSService

logger = logging.getLogger(__name__)

_INDEX = Path(__file__).parent / "templates" / "index.html"


def parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser (python-multipart isn't installed)
    -> (fields: dict[str, str], files: dict[name, (filename, bytes)])."""
    m = re.search(r'boundary="?([^";]+)"?', content_type or "")
    if not m:
        raise ValueError("missing multipart boundary")
    boundary = b"--" + m.group(1).encode()
    fields, files = {}, {}
    for part in body.split(boundary)[1:]:
        if part in (b"--", b"--\r\n", b"", b"\r\n"):
            continue
        if part.startswith(b"\r\n"):
            part = part[2:]
        header, sep, payload = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        hdr = header.decode(errors="replace")
        mname = re.search(r'name="([^"]*)"', hdr)
        if not mname:
            continue
        mfile = re.search(r'filename="([^"]*)"', hdr)
        if mfile:
            files[mname.group(1)] = (mfile.group(1), payload)
        else:
            fields[mname.group(1)] = payload.decode(errors="replace")
    return fields, files


# ---------------------------------------------------------------- stdlib HTTP
def make_stdlib_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def _send(self, code, body, ctype="application/json"):
            if isinstance(body, (dict, list)):
                body = json.dumps(body).encode()
            elif isinstance(body, str):
                body = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def _json(self):
            return json.loads(self._body() or b"{}")

        def do_GET(self):
            try:
                path = self.path.split("?")[0]
                if path == "/health":
                    return self._send(200, service.health().model_dump())
                if path == "/emotions":
                    return self._send(200, service.list_emotions().model_dump())
                m = re.fullmatch(r"/emotions/([^/]+)", path)
                if m:
                    prof = service.get_emotion(m.group(1))
                    if prof is None:
                        return self._send(404, {"error": "Emotion not found"})
                    return self._send(200, prof.model_dump())
                if path == "/voices":
                    return self._send(200, service.list_voices())
                m = re.fullmatch(r"/outputs/([^/]+)", path)
                if m:
                    data = service.output_file(m.group(1))
                    if data is None:
                        return self._send(404, {"error": "not found"})
                    return self._send(200, data if isinstance(data, bytes) else bytes(data), "audio/wav")
                if path == "/":
                    return self._send(200, _INDEX.read_text(), "text/html")
                return self._send(404, {"error": "not found"})
            except Exception as e:  # global error handler (server.py:542-554)
                logger.exception("GET %s failed", self.path)
                return self._send(500, {"error": str(e)})

        def do_POST(self):
            try:
                path = self.path.split("?")[0]
                if path == "/generate":
                    req = TTSRequest.parse(self._json())
                    try:
                        return self._send(200, service.generate(req).model_dump())
                    except (KeyError, ValueError) as e:
                        return self._send(400, {"error": str(e)})
                if path == "/generate/stream":
                    req = TTSRequest.parse(self._json())
                    try:
                        gen = service.generate_stream(req)
                        first = next(gen, b"")
                    except (KeyError, ValueError) as e:
                        return self._send(400, {"error": str(e)})
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/L16")
                    self.send_header("X-Sample-Rate", "24000")
                    self.send_header("X-Bit-Depth", "16")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk_out(data):
                        self.wfile.write(f"{len(data):x}\r\n".encode())
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")

                    try:
                        if first:
                            chunk_out(first)
                        for data in gen:
                            chunk_out(data)
                        self.wfile.write(b"0\r\n\r\n")
                    except Exception:
                        # headers + chunks already sent: a 500 response here
                        # would be unframed bytes inside the chunked body.
                        # Drop the connection so the client sees truncation.
                        logger.exception("stream failed mid-body")
                        self.close_connection = True
                    return None
                if path == "/emotions":
                    req = EmotionCreateRequest.parse(self._json())
                    try:
                        return self._send(200, service.create_emotion(req).model_dump())
                    except ValueError as e:
                        return self._send(400, {"error": str(e)})
                m = re.fullmatch(r"/emotions/([^/]+)/test", path)
                if m:
                    return self._send(200, service.test_emotion(m.group(1)).model_dump())
                m = re.fullmatch(r"/emotions/([^/]+)/voices", path)
                if m:
                    try:
                        fields, files = parse_multipart(
                            self._body(), self.headers.get("Content-Type", "")
                        )
                        fname, data = next(iter(files.values()))
                        resp = service.upload_emotion_voice(
                            m.group(1), fname, data, fields.get("description")
                        )
                        return self._send(200, resp.model_dump())
                    except KeyError as e:
                        return self._send(404, {"error": str(e)})
                    except (ValueError, StopIteration) as e:
                        return self._send(400, {"error": str(e)})
                if path == "/voices/upload":
                    q = dict(
                        kv.split("=", 1) for kv in self.path.split("?", 1)[1].split("&")
                    ) if "?" in self.path else {}
                    fname = q.get("filename", "upload.wav")
                    return self._send(200, service.upload_voice(fname, self._body()))
                return self._send(404, {"error": "not found"})
            except ValidationError as e:
                return self._send(422, {"error": "validation", "detail": json.loads(e.json())})
            except Exception as e:
                logger.exception("POST %s failed", self.path)
                return self._send(500, {"error": str(e)})

        def do_PUT(self):
            try:
                m = re.fullmatch(r"/emotions/([^/]+)", self.path.split("?")[0])
                if m:
                    req = EmotionUpdateRequest.parse(self._json())
                    prof = service.update_emotion(m.group(1), req)
                    if prof is None:
                        return self._send(404, {"error": "Emotion not found"})
                    return self._send(200, prof.model_dump())
                return self._send(404, {"error": "not found"})
            except ValidationError as e:
                return self._send(422, {"error": "validation", "detail": json.loads(e.json())})
            except Exception as e:
                logger.exception("PUT %s failed", self.path)
                return self._send(500, {"error": str(e)})

        def do_DELETE(self):
            try:
                path, _, query = self.path.partition("?")
                m = re.fullmatch(r"/emotions/([^/]+)/voices/remove", path)
                if m:
                    q = dict(kv.split("=", 1) for kv in query.split("&") if "=" in kv)
                    from urllib.parse import unquote

                    fname = unquote(q.get("voice_filename", ""))
                    try:
                        return self._send(
                            200, service.remove_emotion_voice(m.group(1), fname)
                        )
                    except KeyError as e:
                        return self._send(404, {"error": str(e)})
                m = re.fullmatch(r"/emotions/([^/]+)", path)
                if m:
                    ok = service.delete_emotion(m.group(1))
                    return self._send(200 if ok else 404, {"deleted": ok and m.group(1)})
                m = re.fullmatch(r"/voices/([^/]+)", path)
                if m:
                    ok = service.delete_voice(m.group(1))
                    return self._send(200 if ok else 404, {"deleted": ok and m.group(1)})
                return self._send(404, {"error": "not found"})
            except Exception as e:
                logger.exception("DELETE %s failed", self.path)
                return self._send(500, {"error": str(e)})

    return Handler


def run_server(cfg: ServerConfig = None, tts=None, background: bool = False,
               service: "TTSService" = None):
    """Serve ``service`` (or a new TTSService over ``tts``) on cfg.host and
    cfg.port. Pass a prebuilt ``service`` to reuse it (run.py seeds profiles
    on one first); a second TTSService would duplicate the VoiceManager and
    orphan a spare batcher worker. With ``background`` the server runs on a
    daemon thread and is returned (``shutdown()`` stops it; ``.service`` is
    the service); else this call serves until interrupted."""
    cfg = cfg or get_config()
    if service is None:
        service = TTSService(cfg, tts=tts)
    httpd = ThreadingHTTPServer((cfg.host, cfg.port), make_stdlib_handler(service))
    httpd.daemon_threads = True
    httpd.service = service  # exposed for tests and embedding
    logger.info("serving with the stdlib HTTP server on %s:%d", *httpd.server_address[:2])
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    httpd.serve_forever()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    run_server()
