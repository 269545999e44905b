"""kaolin-tpu-dash3d: web viewer for Timelapse checkpoint logs.

Port of ``kaolin_tpu/experimental/dash3d/run.py``, itself a re-design of
``kaolin/experimental/dash3d/run.py:42-110`` (Flask+Tornado
+ THREE.js there): one Tornado app serves a self-contained page with a
vanilla-WebGL renderer (``static/render.js`` — no external assets; the
environment has no flask and no CDN access) and streams geometry over a
websocket using the reference's BINARY wire format (see
:mod:`.util`): the server pushes ``{"type": "dirinfo"}`` JSON on
connect, the client requests ``{"type": "geometry", "data": [...]}``
and receives int32-headed binary frames.

Run: ``python -m kaolin_tpu_torch.experimental.dash3d --logdir LOGDIR
[--port P]``. Tornado is imported only when a server starts.
"""

import argparse
import json
import logging
import os

import numpy as np

from .util import StreamingGeometryHelper, TYPE_MESH, TYPE_POINTCLOUD

logger = logging.getLogger(__name__)

_STATIC_DIR = os.path.join(os.path.dirname(__file__), 'static')
_HTML_PATH = os.path.join(os.path.dirname(__file__), 'index.html')


def get_max_viewports(urlargs):
    """Clamped ``maxviews`` URL argument (reference
    ``dash3d/run.py:32``): default 3, bounded to [1, 8]."""
    try:
        return max(1, min(8, int(urlargs.get('maxviews', 3))))
    except (TypeError, ValueError):
        return 3


def create_server(logdir, port):
    import tornado.web
    import tornado.websocket

    helper = StreamingGeometryHelper(logdir)

    class IndexHandler(tornado.web.RequestHandler):
        def get(self):
            with open(_HTML_PATH, 'r', encoding='utf-8') as f:
                self.write(f.read())

    class GeometryWS(tornado.websocket.WebSocketHandler):
        """Reference protocol (``dash3d/util.py:222-330``): dirinfo on
        open; JSON geometry requests; binary geometry responses headed
        by int32 [type_id, view_id, snap_time, 0]."""

        def open(self):
            self.write_message(json.dumps(
                {'type': 'dirinfo', 'data': helper.get_directory_info()}),
                binary=False)

        def on_message(self, message):
            try:
                msg = json.loads(message)
            except Exception as exc:       # noqa: BLE001
                logger.error('Failed to decode incoming message: %s', exc)
                return
            if msg.get('type') == 'dirinfo':
                self.write_message(json.dumps(
                    {'type': 'dirinfo',
                     'data': helper.get_directory_info()}), binary=False)
                return
            if msg.get('type') != 'geometry':
                logger.error('Unsupported message: %r', msg.get('type'))
                return
            for req in msg.get('data') or []:
                reply = self._get_requested_geometry(req)
                if reply is not None:
                    self.write_message(reply, binary=True)

        @staticmethod
        def _get_requested_geometry(req):
            required = ('type', 'category', 'id', 'time', 'view_id')
            if any(k not in req for k in required):
                logger.error('Request missing keys: %r', req)
                return None
            idx = int(req['id'])
            t = float(req['time'])
            cur = float(req['current_time']) \
                if 'current_time' in req and req['current_time'] is not None \
                else None
            kind = req.get('type')
            if kind == 'mesh':
                type_id = TYPE_MESH
                payload, snap = helper.parse_encode_mesh(
                    req['category'], idx, t, current_time=cur)
            elif kind == 'pointcloud':
                type_id = TYPE_POINTCLOUD
                payload, snap = helper.parse_encode_pointcloud(
                    req['category'], idx, t, current_time=cur)
            elif kind == 'voxelgrid':
                type_id = TYPE_POINTCLOUD
                payload, snap = helper.parse_encode_voxelgrid_as_pointcloud(
                    req['category'], idx, t, current_time=cur)
            else:
                logger.error('Unsupported geometry type: %r', kind)
                return None
            if payload is None:
                return None
            head = np.array([type_id, int(req['view_id']), int(snap), 0],
                            np.int32).tobytes()
            return head + payload

    app = tornado.web.Application([
        (r'/', IndexHandler),
        (r'/ws', GeometryWS),
        (r'/static/(.*)', tornado.web.StaticFileHandler,
         {'path': _STATIC_DIR}),
    ])
    app.listen(port)
    return app


def run_main():
    import tornado.ioloop

    p = argparse.ArgumentParser(description='kaolin-tpu dash3d viewer')
    p.add_argument('--logdir', type=str, required=True)
    p.add_argument('--port', type=int, default=8080)
    args = p.parse_args()
    create_server(args.logdir, args.port)
    logging.basicConfig(level=logging.INFO)
    logger.info('kaolin-tpu-dash3d serving %s at http://localhost:%d',
                args.logdir, args.port)
    tornado.ioloop.IOLoop.current().start()


if __name__ == '__main__':
    run_main()
