"""Progressive preview, the headless analog of the reference's live
window (WindowManager.h:79-93 redraws the framebuffer every frame); port
of raytracer_tpu/viewer.py.

`progressive_render` accumulates the samples in batches and writes a
tone-mapped preview PNG after every batch, so the image sharpens as the
reference's window does in its high-quality mode. `serve` starts a
stdlib HTTP server with an auto-refreshing page that shows the latest
preview.
"""

from __future__ import annotations

import http.server
import threading

import torch


@torch.no_grad()
def progressive_render(scene, cam, cfg, key, out_path: str = "preview.png",
                       spp_per_update: int | None = None, on_update=None):
    """Render cfg.spp samples through the megakernel integrator in
    batches, rewriting `out_path` after each; `on_update(done, preview)`
    is called with the samples done and the current mean. Returns the
    final mean linear image f32[H,W,3]: the single-pass render's, since
    draws are keyed by sample."""
    from raytracer_tpu_torch.ops.tonemap import to_rgba8
    from raytracer_tpu_torch.render import iter_spp_accumulation
    from raytracer_tpu_torch.utils.image import write_png

    acc = None
    for done, batch_sum in iter_spp_accumulation(scene, cam, cfg, key, integrator="megakernel",
                                                 spp_per_batch=spp_per_update):
        acc = batch_sum if acc is None else acc + batch_sum
        preview = acc / done
        write_png(out_path, to_rgba8(preview).cpu().numpy())
        if on_update:
            on_update(done, preview)
    return acc / cfg.spp


_PAGE = """<!doctype html><title>raytracer_tpu_torch preview</title>
<body style="background:#111;margin:0;display:grid;place-items:center;height:100vh">
<img id="i" style="max-width:100vw;max-height:100vh;image-rendering:pixelated">
<script>setInterval(()=>{document.getElementById('i').src='/preview.png?'+Date.now()},1000)</script>
"""


def serve(directory: str, port: int = 8000, preview_name: str = "preview.png"):
    """Serve `directory` with an auto-refreshing index page showing
    `preview_name`, from a daemon thread. Returns the server (its
    `server_address` holds the port; port 0 picks a free one); call its
    `shutdown()` and `server_close()` to stop it."""

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=directory, **kw)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _PAGE.replace("preview.png", preview_name).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                super().do_GET()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
