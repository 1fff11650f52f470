// Monotone flood fill for Lyapunov-region extraction.
//
// The port's copy of safe_learning_tpu/native/flood_fill.cpp: the
// priority-queue expansion of
// safe_learning_tpu_torch.lyapunov.get_lyapunov_region (the reference
// safe_learning's lyapunov.py:59-139). Starting from an initial node, it
// expands over grid neighbors in increasing-value order, stopping at the
// domain boundary or at the first non-monotone pop. The algorithm is
// sequential (a heap ordered by value), so it runs on the host; this C++
// version replaces a Python heapq loop that dominates at 10^6+ grid
// points.
//
// Build: g++ -O3 -shared -fPIC flood_fill.cpp -o libfloodfill.so
// (safe_learning_tpu_torch/native/__init__.py does it at first use).
// ABI: plain C, called via ctypes.

#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Node {
    double value;
    int64_t tiebreak;
    int64_t index;  // flat C-order index
};

struct NodeGreater {
    bool operator()(const Node& a, const Node& b) const {
        if (a.value != b.value) return a.value > b.value;
        return a.tiebreak > b.tiebreak;
    }
};

}  // namespace

extern "C" int lyapunov_flood_fill(
    const double* values,     // flat C-order grid values, length nindex
    const int64_t* shape,     // grid shape, length ndim
    int ndim,
    int64_t init_index,       // flat index of the seed node
    uint8_t* visited)         // out: flat visited mask, length nindex
{
    if (ndim <= 0 || ndim > 16) return -1;

    int64_t nindex = 1;
    std::vector<int64_t> strides(ndim);
    for (int d = ndim - 1; d >= 0; --d) {
        strides[d] = nindex;
        nindex *= shape[d];
    }
    if (init_index < 0 || init_index >= nindex) return -1;

    // Neighbor offsets: all 3^ndim - 1 combinations of {0, -1, +1}.
    std::vector<std::vector<int>> offsets;
    {
        std::vector<int> combo(ndim, 0);
        int total = 1;
        for (int d = 0; d < ndim; ++d) total *= 3;
        const int digits[3] = {0, -1, 1};
        for (int c = 1; c < total; ++c) {  // skip the all-zero offset
            int rem = c;
            std::vector<int> off(ndim);
            for (int d = ndim - 1; d >= 0; --d) {
                off[d] = digits[rem % 3];
                rem /= 3;
            }
            offsets.push_back(std::move(off));
        }
    }

    std::priority_queue<Node, std::vector<Node>, NodeGreater> heap;
    std::vector<int64_t> coord(ndim), ncoord(ndim);

    visited[init_index] = 1;
    int64_t tiebreak = 0;
    heap.push(Node{values[init_index], tiebreak++, init_index});
    double last_value = values[init_index];

    while (!heap.empty()) {
        Node node = heap.top();
        heap.pop();

        // Unravel the flat index.
        int64_t rem = node.index;
        bool on_boundary = false;
        for (int d = 0; d < ndim; ++d) {
            coord[d] = rem / strides[d];
            rem %= strides[d];
            if (coord[d] == 0 || coord[d] == shape[d] - 1)
                on_boundary = true;
        }
        if (on_boundary) {
            visited[node.index] = 0;
            break;
        }
        if (node.value < last_value) break;
        last_value = node.value;

        for (const auto& off : offsets) {
            int64_t nidx = 0;
            for (int d = 0; d < ndim; ++d) {
                ncoord[d] = coord[d] + off[d];
                nidx += ncoord[d] * strides[d];
            }
            // Interior-coordinates guaranteed in range: the popped node
            // is not on the boundary.
            if (!visited[nidx]) {
                visited[nidx] = 1;
                heap.push(Node{values[nidx], tiebreak++, nidx});
            }
        }
    }

    // Remaining queued nodes were visited but never expanded.
    while (!heap.empty()) {
        visited[heap.top().index] = 0;
        heap.pop();
    }
    return 0;
}
