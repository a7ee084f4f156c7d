// Host code: sequential label-propagation coarsening for the multilevel
// hierarchy, and the edge-list parser.  Not device kernels: the coarsening
// runs once per hierarchy build, the parser once per graph read.
//
// Label propagation is inherently sequential (each node's move depends on
// all earlier moves in the same sweep — reference
// src/embeddingLib/src/partition/LabelPropagation.cpp:58-110), so it cannot
// be vectorized without changing semantics.  The same three entry points
// as wembed_tpu/_native/labelprop.cpp, with the same arithmetic, so both
// packages build the same hierarchy and read the same pairs.
//
// Exposed via a plain C ABI, loaded from Python with ctypes
// (wembed_tpu_torch/multilevel/label_prop.py, wembed_tpu_torch/graphs/io.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Size-capped weighted label propagation, one call = the reference's full
// NUM_ITERATIONS sweep loop (LabelPropagation.cpp:58-110).
// row_ptr: (n+1) CSR offsets; col: (2m) neighbors; ew: (2m) edge weights
// order: (n) node visit order; out_cluster: (n) result (uncompacted)
void wembed_label_propagation(
    int64_t n,
    const int64_t* row_ptr,
    const int32_t* col,
    const double* ew,
    const int32_t* order,
    int32_t num_iterations,
    int32_t max_cluster_size,
    int32_t* out_cluster) {
    std::vector<int32_t> cluster(n);
    std::vector<double> edge_sum(n, 0.0);
    std::vector<int32_t> cluster_size(n, 0);

    // initial assignment: cluster id == node id.  Sizes start at 0, not 1:
    // the size-cap test below counts only nodes that have MOVED into a
    // cluster (LabelPropagation.cpp:70-76), so a node's own singleton
    // never blocks its first move.
    for (int64_t i = 0; i < n; i++) cluster[i] = (int32_t)i;

    for (int32_t it = 0; it < num_iterations; it++) {
        for (int64_t vi = 0; vi < n; vi++) {
            const int32_t v = order[vi];
            const int64_t begin = row_ptr[v], end = row_ptr[v + 1];

            // accumulate v's edge weight per adjacent cluster; the second
            // neighbor pass below zeroes each touched slot, so edge_sum
            // stays all-zero between nodes without an O(n) clear
            for (int64_t e = begin; e < end; e++) {
                edge_sum[cluster[col[e]]] += ew[e];
            }

            const int32_t original = cluster[v];
            int32_t largest = original;
            double max_weight = 0.0;
            for (int64_t e = begin; e < end; e++) {
                const int32_t c = cluster[col[e]];
                if (edge_sum[c] > max_weight &&
                    ((cluster_size[c] + 1) <= max_cluster_size || c == original)) {
                    max_weight = edge_sum[c];
                    largest = c;
                }
                edge_sum[c] = 0.0;  // reset for the next node
            }

            cluster_size[largest] += 1;
            cluster_size[original] -= 1;
            cluster[v] = largest;
        }
    }

    std::memcpy(out_cluster, cluster.data(), n * sizeof(int32_t));
}

// Aggressive pass when a level shrank < 2x: merge single-child nodes into
// their heaviest-edge neighbor, pair up degree-0 nodes
// (LabelPropagation.cpp:112-179).
void wembed_aggressive_propagation(
    int64_t n,
    const int64_t* row_ptr,
    const int32_t* col,
    const double* ew,
    const int32_t* prev_parents,  // (prev_n) mapping of the FINER layer
    int64_t prev_n,
    int32_t* out_cluster) {
    std::vector<int32_t> num_children(n, 0);
    std::vector<int32_t> cluster(n, -1);
    std::vector<double> edge_sum(n, 0.0);
    std::vector<int32_t> degree_zero;

    for (int64_t c = 0; c < prev_n; c++) num_children[prev_parents[c]] += 1;

    for (int64_t v = 0; v < n; v++) {
        if (num_children[v] > 1) {
            cluster[v] = (int32_t)v;
            continue;
        }
        const int64_t begin = row_ptr[v], end = row_ptr[v + 1];
        if (end > begin) {
            for (int64_t e = begin; e < end; e++) edge_sum[col[e]] += ew[e];
            int32_t largest = -1;
            double max_weight = -1.0;
            for (int64_t e = begin; e < end; e++) {
                const int32_t t = col[e];
                if (edge_sum[t] > max_weight) {
                    max_weight = edge_sum[t];
                    largest = t;
                }
                edge_sum[t] = 0.0;
            }
            cluster[v] = largest;
        } else {
            degree_zero.push_back((int32_t)v);
        }
    }

    for (size_t i = 0; i < degree_zero.size(); i++) {
        const int32_t v = degree_zero[i];
        cluster[v] = (i % 2 == 1) ? degree_zero[i - 1] : v;
    }

    std::memcpy(out_cluster, cluster.data(), n * sizeof(int32_t));
}

// Whitespace edge-list parser (the JAX package's wembed_parse_edge_list):
// fills pairs[2*k], pairs[2*k+1] with the first two integers of every line
// that has them; blank lines, lines starting with comment_char and lines
// without two leading integers are skipped, and tokens after the second
// integer are ignored.  Writes at most `capacity` pairs and returns the
// number of pairs in the file, or -1 when the file cannot be read
// (wembed_tpu_torch/graphs/io.py:read_edge_list).
int64_t wembed_parse_edge_list(
    const char* path, char comment_char, int64_t* pairs, int64_t capacity) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    const long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (size < 0) {
        fclose(f);
        return -1;
    }
    std::vector<char> buf(size + 1);
    if (size > 0 && fread(buf.data(), 1, size, f) != (size_t)size) {
        fclose(f);
        return -1;
    }
    fclose(f);
    buf[size] = '\0';

    int64_t count = 0;
    const char* p = buf.data();
    const char* endp = buf.data() + size;
    while (p < endp) {
        // skip leading whitespace
        while (p < endp && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
        if (p >= endp) break;
        if (*p == '\n') { p++; continue; }
        if (*p == comment_char) {
            while (p < endp && *p != '\n') p++;
            continue;
        }
        char* next = nullptr;
        const int64_t a = strtoll(p, &next, 10);
        if (next == p) { while (p < endp && *p != '\n') p++; continue; }
        p = next;
        while (p < endp && (*p == ' ' || *p == '\t')) p++;
        const int64_t b = strtoll(p, &next, 10);
        if (next == p) { while (p < endp && *p != '\n') p++; continue; }
        p = next;
        while (p < endp && *p != '\n') p++;
        if (count < capacity) {
            pairs[2 * count] = a;
            pairs[2 * count + 1] = b;
        }
        count++;
    }
    return count;
}

}  // extern "C"
