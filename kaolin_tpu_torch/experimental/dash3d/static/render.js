/* dash3d WebGL renderer + app (self-contained replacement for the
 * reference's THREE.js client, src/render.js + src/geometry.js).
 *
 * Each viewport owns a canvas, an orbit camera and one geometry; the
 * app connects the websocket, renders the dirinfo sidebar, drives the
 * time slider and keeps viewports in sync with binary updates. */
'use strict';

/* ----------------------------- tiny mat4 ------------------------------ */
const M4 = {
    identity: function () {
        return new Float32Array([1, 0, 0, 0, 0, 1, 0, 0,
                                 0, 0, 1, 0, 0, 0, 0, 1]);
    },
    mul: function (a, b) {
        const o = new Float32Array(16);
        for (let c = 0; c < 4; c++) {
            for (let r = 0; r < 4; r++) {
                let s = 0;
                for (let k = 0; k < 4; k++) {
                    s += a[k * 4 + r] * b[c * 4 + k];
                }
                o[c * 4 + r] = s;
            }
        }
        return o;
    },
    perspective: function (fovy, aspect, near, far) {
        const f = 1.0 / Math.tan(fovy / 2);
        const o = new Float32Array(16);
        o[0] = f / aspect; o[5] = f;
        o[10] = (far + near) / (near - far); o[11] = -1;
        o[14] = 2 * far * near / (near - far);
        return o;
    },
    lookAt: function (eye, at, up) {
        const z = norm3(sub3(eye, at));
        const x = norm3(cross3(up, z));
        const y = cross3(z, x);
        return new Float32Array([
            x[0], y[0], z[0], 0,
            x[1], y[1], z[1], 0,
            x[2], y[2], z[2], 0,
            -dot3(x, eye), -dot3(y, eye), -dot3(z, eye), 1]);
    },
};
function sub3(a, b) { return [a[0] - b[0], a[1] - b[1], a[2] - b[2]]; }
function dot3(a, b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }
function cross3(a, b) {
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]];
}
function norm3(a) {
    const l = Math.hypot(a[0], a[1], a[2]) || 1;
    return [a[0] / l, a[1] / l, a[2] / l];
}

/* ----------------------------- shaders -------------------------------- */
const MESH_VS = `
attribute vec3 aPos; attribute vec3 aNrm;
uniform mat4 uProj, uView;
varying vec3 vNrm; varying vec3 vPos;
void main() {
    vNrm = aNrm; vPos = aPos;
    gl_Position = uProj * uView * vec4(aPos, 1.0);
}`;
const MESH_FS = `
precision mediump float;
varying vec3 vNrm; varying vec3 vPos;
uniform vec3 uEye; uniform vec3 uColor;
void main() {
    vec3 n = normalize(vNrm);
    vec3 l = normalize(uEye - vPos);
    float d = abs(dot(n, l));
    float spec = pow(max(d, 0.0), 16.0) * 0.25;
    vec3 c = uColor * (0.25 + 0.7 * d) + vec3(spec);
    gl_FragColor = vec4(c, 1.0);
}`;
const PTS_VS = `
attribute vec3 aPos;
uniform mat4 uProj, uView; uniform float uSize;
varying vec3 vPos;
void main() {
    vPos = aPos;
    gl_Position = uProj * uView * vec4(aPos, 1.0);
    gl_PointSize = uSize;
}`;
const PTS_FS = `
precision mediump float;
varying vec3 vPos; uniform vec3 uColor;
void main() {
    vec2 d = gl_PointCoord - vec2(0.5);
    if (dot(d, d) > 0.25) discard;
    gl_FragColor = vec4(uColor * (0.6 + 0.4 * vPos.y), 1.0);
}`;

function compile(gl, vsSrc, fsSrc) {
    function sh(type, src) {
        const s = gl.createShader(type);
        gl.shaderSource(s, src);
        gl.compileShader(s);
        if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) {
            throw new Error(gl.getShaderInfoLog(s));
        }
        return s;
    }
    const p = gl.createProgram();
    gl.attachShader(p, sh(gl.VERTEX_SHADER, vsSrc));
    gl.attachShader(p, sh(gl.FRAGMENT_SHADER, fsSrc));
    gl.linkProgram(p);
    if (!gl.getProgramParameter(p, gl.LINK_STATUS)) {
        throw new Error(gl.getProgramInfoLog(p));
    }
    return p;
}

/* ----------------------------- viewport ------------------------------- */
class Viewport {
    constructor(container, viewId, label) {
        this.viewId = viewId;
        this.label = label;
        this.root = document.createElement('div');
        this.root.className = 'viewport';
        const cap = document.createElement('div');
        cap.className = 'viewport-label';
        cap.textContent = label;
        this.canvas = document.createElement('canvas');
        this.canvas.width = 420;
        this.canvas.height = 320;
        this.root.appendChild(this.canvas);
        this.root.appendChild(cap);
        container.appendChild(this.root);
        this.gl = this.canvas.getContext('webgl');
        this.theta = 0.9;
        this.phi = 0.7;
        this.radius = 3.0;
        this.center = [0, 0, 0];
        this.nVerts = 0;
        this.kind = null;
        this.currentTime = null;
        this._bindMouse();
        if (this.gl) {
            this.meshProg = compile(this.gl, MESH_VS, MESH_FS);
            this.ptsProg = compile(this.gl, PTS_VS, PTS_FS);
            this.posBuf = this.gl.createBuffer();
            this.nrmBuf = this.gl.createBuffer();
        }
    }

    _bindMouse() {
        let drag = false, px = 0, py = 0;
        this.canvas.addEventListener('mousedown', (e) => {
            drag = true; px = e.clientX; py = e.clientY;
        });
        window.addEventListener('mouseup', () => { drag = false; });
        window.addEventListener('mousemove', (e) => {
            if (!drag) return;
            this.theta += (e.clientX - px) * 0.01;
            this.phi = Math.min(1.5, Math.max(-1.5,
                this.phi + (e.clientY - py) * 0.01));
            px = e.clientX; py = e.clientY;
            this.draw();
        });
        this.canvas.addEventListener('wheel', (e) => {
            e.preventDefault();
            this.radius *= Math.exp(e.deltaY * 0.001);
            this.draw();
        }, {passive: false});
    }

    setGeometry(msg) {
        const G = window.Dash3DGeometry;
        if (!msg.items.length || !this.gl) return;
        const item = msg.items[0];
        const gl = this.gl;
        const bbox = G.geometryBBox(item);
        this.center = [(bbox.min[0] + bbox.max[0]) / 2,
                       (bbox.min[1] + bbox.max[1]) / 2,
                       (bbox.min[2] + bbox.max[2]) / 2];
        const diag = Math.hypot(bbox.max[0] - bbox.min[0],
                                bbox.max[1] - bbox.min[1],
                                bbox.max[2] - bbox.min[2]) || 1;
        this.radius = diag * 1.6;
        if (msg.typeId === G.TYPE_MESH) {
            const flat = G.meshToFlatArrays(item.vertices, item.faces);
            gl.bindBuffer(gl.ARRAY_BUFFER, this.posBuf);
            gl.bufferData(gl.ARRAY_BUFFER, flat.positions, gl.STATIC_DRAW);
            gl.bindBuffer(gl.ARRAY_BUFFER, this.nrmBuf);
            gl.bufferData(gl.ARRAY_BUFFER, flat.normals, gl.STATIC_DRAW);
            this.nVerts = flat.positions.length / 3;
            this.kind = 'mesh';
        } else {
            gl.bindBuffer(gl.ARRAY_BUFFER, this.posBuf);
            gl.bufferData(gl.ARRAY_BUFFER, item.points, gl.STATIC_DRAW);
            this.nVerts = item.points.length / 3;
            this.kind = 'pointcloud';
        }
        this.currentTime = msg.snapTime;
        this.draw();
    }

    draw() {
        const gl = this.gl;
        if (!gl || !this.kind) return;
        gl.viewport(0, 0, this.canvas.width, this.canvas.height);
        gl.clearColor(0.09, 0.1, 0.12, 1.0);
        gl.enable(gl.DEPTH_TEST);
        gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
        const eye = [
            this.center[0] + this.radius * Math.cos(this.phi)
                * Math.sin(this.theta),
            this.center[1] + this.radius * Math.sin(this.phi),
            this.center[2] + this.radius * Math.cos(this.phi)
                * Math.cos(this.theta)];
        const view = M4.lookAt(eye, this.center, [0, 1, 0]);
        const proj = M4.perspective(
            0.8, this.canvas.width / this.canvas.height,
            0.01 * this.radius, 100 * this.radius);
        const prog = this.kind === 'mesh' ? this.meshProg : this.ptsProg;
        gl.useProgram(prog);
        gl.uniformMatrix4fv(gl.getUniformLocation(prog, 'uProj'), false,
                            proj);
        gl.uniformMatrix4fv(gl.getUniformLocation(prog, 'uView'), false,
                            view);
        gl.uniform3fv(gl.getUniformLocation(prog, 'uColor'),
                      this.kind === 'mesh' ? [0.45, 0.62, 0.85]
                                           : [0.95, 0.7, 0.3]);
        const aPos = gl.getAttribLocation(prog, 'aPos');
        gl.bindBuffer(gl.ARRAY_BUFFER, this.posBuf);
        gl.enableVertexAttribArray(aPos);
        gl.vertexAttribPointer(aPos, 3, gl.FLOAT, false, 0, 0);
        if (this.kind === 'mesh') {
            gl.uniform3fv(gl.getUniformLocation(prog, 'uEye'), eye);
            const aNrm = gl.getAttribLocation(prog, 'aNrm');
            gl.bindBuffer(gl.ARRAY_BUFFER, this.nrmBuf);
            gl.enableVertexAttribArray(aNrm);
            gl.vertexAttribPointer(aNrm, 3, gl.FLOAT, false, 0, 0);
            gl.drawArrays(gl.TRIANGLES, 0, this.nVerts);
        } else {
            gl.uniform1f(gl.getUniformLocation(prog, 'uSize'), 3.0);
            gl.drawArrays(gl.POINTS, 0, this.nVerts);
        }
    }
}

/* ------------------------------- app ---------------------------------- */
class Dash3DApp {
    constructor() {
        this.views = [];
        this.dirinfo = null;
        this.times = [0];
        this.status = document.getElementById('status');
        this.sidebar = document.getElementById('entries');
        this.viewsEl = document.getElementById('views');
        this.slider = document.getElementById('time');
        this.timeLabel = document.getElementById('time-label');
        this.slider.addEventListener('input', () => this.requestAll());
        this.connect();
    }

    connect() {
        const proto = location.protocol === 'https:' ? 'wss' : 'ws';
        this.ws = new WebSocket(`${proto}://${location.host}/ws`);
        this.ws.binaryType = 'arraybuffer';
        this.ws.onopen = () => { this.status.textContent = 'connected'; };
        this.ws.onclose = () => {
            this.status.textContent = 'disconnected — retrying…';
            setTimeout(() => this.connect(), 2000);
        };
        this.ws.onmessage = (ev) => {
            if (typeof ev.data === 'string') {
                const msg = JSON.parse(ev.data);
                if (msg.type === 'dirinfo') this.setDirinfo(msg.data);
            } else {
                const parsed =
                    window.Dash3DGeometry.parseBinaryMessage(ev.data);
                const vp = this.views[parsed.viewId];
                if (vp) vp.setGeometry(parsed);
            }
        };
    }

    setDirinfo(info) {
        this.dirinfo = info;
        this.sidebar.innerHTML = '';
        this.viewsEl.innerHTML = '';
        this.views = [];
        const allTimes = new Set([0]);
        for (const kind of ['mesh', 'pointcloud', 'voxelgrid']) {
            for (const entry of info[kind] || []) {
                (entry.times || []).forEach((t) => allTimes.add(t));
                const viewId = this.views.length;
                const label = `${kind} · ${entry.category} · #${entry.id}`;
                const vp = new Viewport(this.viewsEl, viewId, label);
                vp.request = {type: kind, category: entry.category,
                              id: entry.id, view_id: viewId};
                this.views.push(vp);
                const row = document.createElement('div');
                row.className = 'entry';
                row.textContent = label;
                this.sidebar.appendChild(row);
            }
        }
        this.times = Array.from(allTimes).sort((a, b) => a - b);
        this.slider.max = String(this.times.length - 1);
        this.requestAll();
    }

    requestAll() {
        if (!this.ws || this.ws.readyState !== WebSocket.OPEN) return;
        const t = this.times[parseInt(this.slider.value, 10)] || 0;
        this.timeLabel.textContent = `iter ${t}`;
        const data = this.views.map((vp) => Object.assign(
            {time: t, current_time: vp.currentTime}, vp.request));
        if (data.length) {
            this.ws.send(JSON.stringify({type: 'geometry', data: data}));
        }
    }
}

if (typeof window !== 'undefined') {
    window.Dash3DApp = Dash3DApp;
    window.addEventListener('DOMContentLoaded', () => {
        window.dash3d = new Dash3DApp();
    });
}
