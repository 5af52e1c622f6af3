// Native (C++17) geometry kernels for the DTU benchmark pipeline:
//   * mesh_supersample — barycentric-grid supersampling of mesh triangles,
//     the capability of the reference's MATLAB MEX kernel
//     (the reference's matlab_eval/MeshSupSamp_web/MeshSupSamp/MeshSupSamp.cpp):
//     for each triangle emit interior points on a (n1+1)x(n2+1) grid with
//     spacing thresh*sqrt(l1*l2/(2*area)), keeping k1+k2<1; output includes
//     the original vertices.
//   * KD-tree nearest-neighbor distances (MaxDistCP.m) and stochastic
//     radius suppression (reducePts_haa.m), multithreaded.
//
// Built as a plain shared library; Python binds via ctypes (no pybind11).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <numeric>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
};

static inline Vec3 sub(const Vec3 &a, const Vec3 &b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
static inline Vec3 cross(const Vec3 &a, const Vec3 &b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
static inline double norm(const Vec3 &a) {
    return std::sqrt(a.x * a.x + a.y * a.y + a.z * a.z);
}

// ---------------------------------------------------------------------------
// KD-tree (3-D, median split, iterative queries)
// ---------------------------------------------------------------------------

struct KDTree {
    // flat node layout: node i has children 2i+1 / 2i+2 over index ranges
    std::vector<int> order;        // point index permutation (in-order)
    std::vector<const double *> pts;  // base pointer, stride 3
    const double *base = nullptr;
    int n = 0;

    struct Frame { int lo, hi, axis; };

    void build(const double *points, int count) {
        base = points;
        n = count;
        order.resize(n);
        std::iota(order.begin(), order.end(), 0);
        std::vector<Frame> stack{{0, n, 0}};
        while (!stack.empty()) {
            Frame f = stack.back();
            stack.pop_back();
            if (f.hi - f.lo <= 8) continue;
            int mid = (f.lo + f.hi) / 2;
            const double *b = base;
            int ax = f.axis;
            std::nth_element(order.begin() + f.lo, order.begin() + mid,
                             order.begin() + f.hi,
                             [b, ax](int a, int c) {
                                 return b[3 * a + ax] < b[3 * c + ax];
                             });
            stack.push_back({f.lo, mid, (f.axis + 1) % 3});
            stack.push_back({mid + 1, f.hi, (f.axis + 1) % 3});
        }
    }

    inline double coord(int idx, int axis) const { return base[3 * idx + axis]; }

    // squared distance helpers
    inline double dist2(int idx, const double *q) const {
        double dx = coord(idx, 0) - q[0];
        double dy = coord(idx, 1) - q[1];
        double dz = coord(idx, 2) - q[2];
        return dx * dx + dy * dy + dz * dz;
    }

    double nearest(const double *q, double best2) const {
        struct QF { int lo, hi, axis; double off2; };
        std::vector<QF> stack;
        stack.reserve(64);
        stack.push_back({0, n, 0, 0.0});
        while (!stack.empty()) {
            QF f = stack.back();
            stack.pop_back();
            if (f.off2 >= best2) continue;
            if (f.hi - f.lo <= 8) {
                for (int i = f.lo; i < f.hi; ++i)
                    best2 = std::min(best2, dist2(order[i], q));
                continue;
            }
            int mid = (f.lo + f.hi) / 2;
            int pid = order[mid];
            best2 = std::min(best2, dist2(pid, q));
            double delta = q[f.axis] - coord(pid, f.axis);
            double d2 = delta * delta;
            int next_axis = (f.axis + 1) % 3;
            if (delta < 0) {  // near side = left
                stack.push_back({mid + 1, f.hi, next_axis, d2});
                stack.push_back({f.lo, mid, next_axis, 0.0});
            } else {
                stack.push_back({f.lo, mid, next_axis, d2});
                stack.push_back({mid + 1, f.hi, next_axis, 0.0});
            }
        }
        return best2;
    }

    template <typename F>
    void within(const double *q, double radius2, F &&fn) const {
        struct QF { int lo, hi, axis; };
        std::vector<QF> stack;
        stack.reserve(64);
        stack.push_back({0, n, 0});
        while (!stack.empty()) {
            QF f = stack.back();
            stack.pop_back();
            if (f.hi - f.lo <= 8) {
                for (int i = f.lo; i < f.hi; ++i)
                    if (dist2(order[i], q) <= radius2) fn(order[i]);
                continue;
            }
            int mid = (f.lo + f.hi) / 2;
            int pid = order[mid];
            if (dist2(pid, q) <= radius2) fn(pid);
            double delta = q[f.axis] - coord(pid, f.axis);
            int next_axis = (f.axis + 1) % 3;
            if (delta * delta <= radius2) {
                stack.push_back({f.lo, mid, next_axis});
                stack.push_back({mid + 1, f.hi, next_axis});
            } else if (delta < 0) {
                stack.push_back({f.lo, mid, next_axis});
            } else {
                stack.push_back({mid + 1, f.hi, next_axis});
            }
        }
    }
};

static void parallel_for(int n, int n_threads,
                         const std::function<void(int, int)> &body) {
    if (n_threads <= 1) {
        body(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int lo = t * chunk, hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(body, lo, hi);
    }
    for (auto &th : threads) th.join();
}

}  // namespace

extern "C" {

// Nearest-neighbor distances: for each of nq query points, the distance to
// the closest of nr ref points, capped at max_dist. MaxDistCP.m semantics.
void nn_distances(const double *query, int64_t nq, const double *ref,
                  int64_t nr, double max_dist, double *out, int n_threads) {
    KDTree tree;
    tree.build(ref, (int)nr);
    double cap2 = max_dist * max_dist;
    parallel_for((int)nq, n_threads, [&](int lo, int hi) {
        for (int i = lo; i < hi; ++i) {
            double d2 = tree.nearest(query + 3 * i, cap2);
            out[i] = std::sqrt(std::min(d2, cap2));
        }
    });
}

// Stochastic radius suppression: visit points in `order`; keep a point iff
// not yet suppressed, then suppress all neighbors within dst.
// reducePts_haa.m semantics. keep: uint8[n] output.
void reduce_points(const double *pts, int64_t n, const int32_t *order,
                   double dst, uint8_t *keep) {
    KDTree tree;
    tree.build(pts, (int)n);
    std::fill(keep, keep + n, 1);
    double r2 = dst * dst;
    for (int64_t i = 0; i < n; ++i) {
        int pid = order[i];
        if (!keep[pid]) continue;
        tree.within(pts + 3 * pid, r2, [&](int j) { keep[j] = 0; });
        keep[pid] = 1;
    }
}

// Mesh supersampling, phase 1: count output points (verts + interior grid
// points of every triangle) so the caller can allocate.
int64_t mesh_supersample_count(const double *verts, int64_t n_verts,
                               const int32_t *tris, int64_t n_tris,
                               double thresh) {
    int64_t count = n_verts;
    for (int64_t t = 0; t < n_tris; ++t) {
        Vec3 q0{verts[3 * tris[3 * t]], verts[3 * tris[3 * t] + 1],
                verts[3 * tris[3 * t] + 2]};
        Vec3 q1{verts[3 * tris[3 * t + 1]], verts[3 * tris[3 * t + 1] + 1],
                verts[3 * tris[3 * t + 1] + 2]};
        Vec3 q2{verts[3 * tris[3 * t + 2]], verts[3 * tris[3 * t + 2] + 1],
                verts[3 * tris[3 * t + 2] + 2]};
        Vec3 v1 = sub(q1, q0), v2 = sub(q2, q0);
        double l1 = norm(v1), l2 = norm(v2);
        double area2 = norm(cross(v1, v2));
        if (area2 <= 0) continue;
        double thr = thresh * std::sqrt(l1 * l2 / area2);
        double n1 = std::floor(l1 / thr), n2 = std::floor(l2 / thr);
        for (double c1 = 0; c1 <= n1; ++c1)
            for (double c2 = 0; c2 <= n2; ++c2)
                if ((c1 + 0.5) / n1 + (c2 + 0.5) / n2 < 1.0) ++count;
    }
    return count;
}

// Mesh supersampling, phase 2: write points into out[count*3].
void mesh_supersample_fill(const double *verts, int64_t n_verts,
                           const int32_t *tris, int64_t n_tris,
                           double thresh, double *out) {
    std::memcpy(out, verts, sizeof(double) * 3 * n_verts);
    int64_t w = n_verts;
    for (int64_t t = 0; t < n_tris; ++t) {
        Vec3 q0{verts[3 * tris[3 * t]], verts[3 * tris[3 * t] + 1],
                verts[3 * tris[3 * t] + 2]};
        Vec3 q1{verts[3 * tris[3 * t + 1]], verts[3 * tris[3 * t + 1] + 1],
                verts[3 * tris[3 * t + 1] + 2]};
        Vec3 q2{verts[3 * tris[3 * t + 2]], verts[3 * tris[3 * t + 2] + 1],
                verts[3 * tris[3 * t + 2] + 2]};
        Vec3 v1 = sub(q1, q0), v2 = sub(q2, q0);
        double l1 = norm(v1), l2 = norm(v2);
        double area2 = norm(cross(v1, v2));
        if (area2 <= 0) continue;
        double thr = thresh * std::sqrt(l1 * l2 / area2);
        double n1 = std::floor(l1 / thr), n2 = std::floor(l2 / thr);
        for (double c1 = 0; c1 <= n1; ++c1) {
            for (double c2 = 0; c2 <= n2; ++c2) {
                double k1 = (c1 + 0.5) / n1, k2 = (c2 + 0.5) / n2;
                if (k1 + k2 < 1.0) {
                    out[3 * w] = k1 * v1.x + k2 * v2.x + q0.x;
                    out[3 * w + 1] = k1 * v1.y + k2 * v2.y + q0.y;
                    out[3 * w + 2] = k1 * v1.z + k2 * v2.z + q0.z;
                    ++w;
                }
            }
        }
    }
}

}  // extern "C"
