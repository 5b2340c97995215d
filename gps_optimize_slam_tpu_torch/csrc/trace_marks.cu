// The tracer's device marks and the kernel-node count of a captured graph
// (utils/profiling.py, utils/graphs.py).
//
// A mark is one thread of one block: it reads %globaltimer (the card's
// nanosecond clock), takes slot n of a ring in device memory with an atomic
// add on the ring's head, and writes the stamp and the mark's id there, at
// n % capacity. header[0] is the head (marks taken since the ring was
// zeroed), header[1] the tail (marks the host has read); a mark that finds
// the ring full (n - tail >= capacity) writes nothing, and the host counts
// it as dropped (head - tail - capacity at its next read). Captured into a
// CUDA graph a mark is a kernel node: it runs on every replay, and the host
// reads the ring once, after a synchronisation.

#include "common.cuh"

namespace {

__global__ void mark_kernel(unsigned long long* header, long long* stamps, int* ids, int capacity, int id) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long n = atomicAdd(header, 1ULL);
  const unsigned long long tail = *reinterpret_cast<volatile unsigned long long*>(header + 1);
  if (n - tail < static_cast<unsigned long long>(capacity)) {
    const unsigned long long slot = n % static_cast<unsigned long long>(capacity);
    stamps[slot] = static_cast<long long>(now);
    ids[slot] = id;
  }
}

long long kernel_nodes(cudaGraph_t graph) {
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess) return -1;
  if (n == 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  long long kernels = -1;
  if (cudaGraphGetNodes(graph, nodes, &n) == cudaSuccess) {
    kernels = 0;
    for (size_t i = 0; i < n && kernels >= 0; ++i) {
      cudaGraphNodeType type;
      if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) {
        kernels = -1;
      } else if (type == cudaGraphNodeTypeKernel) {
        ++kernels;
      } else if (type == cudaGraphNodeTypeGraph) {
        cudaGraph_t child;
        const long long k = cudaGraphChildGraphNodeGetGraph(nodes[i], &child) == cudaSuccess ? kernel_nodes(child) : -1;
        kernels = k < 0 ? -1 : kernels + k;
      }
    }
  }
  delete[] nodes;
  return kernels;
}

}  // namespace

// One mark on `stream`: header (2 int64), stamps (capacity int64), ids
// (capacity int32), all on the stream's device.
GPS_EXPORT int gps_trace_mark(void* header, void* stamps, void* ids, int capacity, int id, void* stream) {
  mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<unsigned long long*>(header),
                                                              static_cast<long long*>(stamps),
                                                              static_cast<int*>(ids), capacity, id);
  return static_cast<int>(cudaGetLastError());
}

// The kernel nodes of the graph `stream` is capturing now (child graphs
// counted through), or -1 where the stream is not capturing or a query
// fails. Called just before the capture ends.
GPS_EXPORT long long gps_capture_kernel_nodes(void* stream) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id, &graph) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive || graph == nullptr) {
    return -1;
  }
  return kernel_nodes(graph);
}

// The kernel nodes of a graph (a cudaGraph_t, e.g. torch's
// CUDAGraph(keep_graph=True).raw_cuda_graph()), or -1 where a query fails.
GPS_EXPORT long long gps_graph_kernel_nodes(void* graph) { return kernel_nodes(static_cast<cudaGraph_t>(graph)); }
