"""The load generator: a child process that drives `POST /tts`, so that its
JSON and hex work does not share the server's interpreter.

It speaks one JSON line at a time over stdin / stdout:

1. in: {"port", "loop", "clients", "job_size", "seconds", "drain_s",
   "requests": [{"id", "text", "voice", "due"?}], "voices": {key: hex}};
   out: {"ready": true} once every request body can be built;
2. in: "go"; the run; out: {"records": [...]} with, a request, its due
   time (open loops), send time, time of the reply's last byte (all
   `time.monotonic()`, which the parent shares), HTTP status, the WAV's
   sample count and rate, and an error text;
3. in: a list of request ids; out: {id: hex of the WAV served} for them.

Closed loops and jobs send while less than `seconds` has passed since the
first send; open loops send each request at its due time after "go" and
wait for replies up to `drain_s` past the window's close.
"""

from __future__ import annotations

import http.client
import io
import json
import sys
import threading
import time
import wave


class Client:
    def __init__(self, spec: dict):
        self.port = int(spec["port"])
        self.loop = spec["loop"]
        self.seconds = float(spec["seconds"])
        self.drain_s = float(spec["drain_s"])
        self.clients = int(spec.get("clients", 1))
        self.job_size = int(spec.get("job_size", 1))
        self.requests = spec["requests"]
        self.voices = spec["voices"]
        self.records = {}
        self.audio = {}
        self._lock = threading.Lock()
        self.deadline = None

    def body(self, req: dict) -> bytes:
        return json.dumps({"text": req["text"],
                           "spk_audio": self.voices[req["voice"]]}).encode()

    def send(self, req: dict, due=None) -> None:
        """One POST /tts, its times and its WAV."""
        body = self.body(req)
        rec = {"id": req["id"], "due": due, "sent": None, "done": None, "status": None,
               "n_samples": 0, "sr": 0, "error": None}
        with self._lock:
            self.records[req["id"]] = rec
        timeout = None
        if self.deadline is not None:
            timeout = max(1.0, self.deadline - time.monotonic())
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            rec["sent"] = time.monotonic()
            conn.request("POST", "/tts", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            rec["done"] = time.monotonic()
            rec["status"] = resp.status
            if resp.status != 200:
                rec["error"] = data[:300].decode(errors="replace")
                return
            wav = bytes.fromhex(json.loads(data)["audio_hex"])
            with wave.open(io.BytesIO(wav)) as w:
                rec["n_samples"], rec["sr"] = w.getnframes(), w.getframerate()
            self.audio[req["id"]] = wav
        except (OSError, http.client.HTTPException, ValueError, KeyError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        finally:
            conn.close()

    def run(self) -> None:
        if self.loop == "open":
            self._open()
        elif self.loop == "closed":
            self._closed()
        elif self.loop == "jobs":
            self._jobs()
        else:
            raise ValueError(f"unknown loop {self.loop!r}")

    def _open(self) -> None:
        t0 = time.monotonic() + 0.05
        self.deadline = t0 + self.seconds + self.drain_s
        threads = []
        for req in self.requests:
            due = t0 + req["due"]
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            th = threading.Thread(target=self.send, args=(req, due), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(max(0.0, self.deadline - time.monotonic()))

    def _closed(self) -> None:
        nxt = iter(self.requests)
        start = []

        def client():
            while True:
                with self._lock:
                    if start and time.monotonic() - start[0] >= self.seconds:
                        return
                    req = next(nxt)
                    if not start:
                        start.append(time.monotonic())
                self.send(req)
        threads = [threading.Thread(target=client, daemon=True) for _ in range(self.clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    def _jobs(self) -> None:
        reqs = self.requests
        first = None
        for ofs in range(0, len(reqs), self.job_size):
            if first is not None and time.monotonic() - first >= self.seconds:
                return
            threads = [threading.Thread(target=self.send, args=(r,), daemon=True)
                       for r in reqs[ofs:ofs + self.job_size]]
            for th in threads:
                th.start()
            if first is None:
                first = time.monotonic()
            for th in threads:
                th.join()


def main() -> None:
    spec = json.loads(sys.stdin.readline())
    client = Client(spec)
    print(json.dumps({"ready": True}), flush=True)
    if sys.stdin.readline().strip() != "go":
        return
    client.run()
    with client._lock:
        records = [dict(r) for r in client.records.values()]
    print(json.dumps({"records": records}), flush=True)
    ids = json.loads(sys.stdin.readline() or "[]")
    print(json.dumps({str(i): client.audio[i].hex() for i in ids if i in client.audio}),
          flush=True)


if __name__ == "__main__":
    main()
