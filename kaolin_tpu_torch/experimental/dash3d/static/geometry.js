/* Binary geometry protocol parser (client twin of util.py encoders).
 *
 * Frame layout (little-endian):
 *   int32[4] header: [typeId (0 mesh, 1 pointcloud), viewId, snapTime, 0]
 *   int32[4] meta:   [count, textureMode, 0, 0]
 *   per mesh:  int32[2] [nverts, nfaces], f32 verts*3, i32 faces*3
 *   per cloud: int32[2] [npts, 0], f32 bboxMin(3), f32 bboxMax(3), f32 pts*3
 */
'use strict';

const TYPE_MESH = 0;
const TYPE_POINTCLOUD = 1;

function parseBinaryMessage(buffer) {
    const head = new Int32Array(buffer, 0, 4);
    const typeId = head[0], viewId = head[1], snapTime = head[2];
    const meta = new Int32Array(buffer, 16, 4);
    const count = meta[0];
    let off = 32;
    const items = [];
    for (let i = 0; i < count; i++) {
        const ns = new Int32Array(buffer.slice(off, off + 8));
        off += 8;
        if (typeId === TYPE_MESH) {
            const nv = ns[0], nf = ns[1];
            const vertices = new Float32Array(
                buffer.slice(off, off + 12 * nv));
            off += 12 * nv;
            const faces = new Int32Array(buffer.slice(off, off + 12 * nf));
            off += 12 * nf;
            items.push({vertices: vertices, faces: faces});
        } else {
            const np = ns[0];
            const bbox = new Float32Array(buffer.slice(off, off + 24));
            off += 24;
            const points = new Float32Array(
                buffer.slice(off, off + 12 * np));
            off += 12 * np;
            items.push({points: points,
                        bboxMin: bbox.slice(0, 3),
                        bboxMax: bbox.slice(3, 6)});
        }
    }
    return {typeId: typeId, viewId: viewId, snapTime: snapTime,
            items: items};
}

/* Flat-shade prep: de-index triangles and emit per-face normals. */
function meshToFlatArrays(vertices, faces) {
    const nf = faces.length / 3;
    const pos = new Float32Array(nf * 9);
    const nrm = new Float32Array(nf * 9);
    for (let f = 0; f < nf; f++) {
        const ia = faces[3 * f], ib = faces[3 * f + 1],
              ic = faces[3 * f + 2];
        const ax = vertices[3 * ia], ay = vertices[3 * ia + 1],
              az = vertices[3 * ia + 2];
        const bx = vertices[3 * ib], by = vertices[3 * ib + 1],
              bz = vertices[3 * ib + 2];
        const cx = vertices[3 * ic], cy = vertices[3 * ic + 1],
              cz = vertices[3 * ic + 2];
        const ux = bx - ax, uy = by - ay, uz = bz - az;
        const vx = cx - ax, vy = cy - ay, vz = cz - az;
        let nx = uy * vz - uz * vy, ny = uz * vx - ux * vz,
            nz = ux * vy - uy * vx;
        const len = Math.hypot(nx, ny, nz) || 1.0;
        nx /= len; ny /= len; nz /= len;
        const base = 9 * f;
        pos.set([ax, ay, az, bx, by, bz, cx, cy, cz], base);
        nrm.set([nx, ny, nz, nx, ny, nz, nx, ny, nz], base);
    }
    return {positions: pos, normals: nrm};
}

function geometryBBox(item) {
    if (item.bboxMin) {
        return {min: item.bboxMin, max: item.bboxMax};
    }
    const v = item.vertices;
    const mn = [Infinity, Infinity, Infinity];
    const mx = [-Infinity, -Infinity, -Infinity];
    for (let i = 0; i < v.length; i += 3) {
        for (let a = 0; a < 3; a++) {
            if (v[i + a] < mn[a]) mn[a] = v[i + a];
            if (v[i + a] > mx[a]) mx[a] = v[i + a];
        }
    }
    return {min: mn, max: mx};
}

if (typeof window !== 'undefined') {
    window.Dash3DGeometry = {
        TYPE_MESH: TYPE_MESH,
        TYPE_POINTCLOUD: TYPE_POINTCLOUD,
        parseBinaryMessage: parseBinaryMessage,
        meshToFlatArrays: meshToFlatArrays,
        geometryBBox: geometryBBox,
    };
}
