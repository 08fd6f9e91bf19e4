// Test helpers for the card tests: fill every word of a CTA's dynamic shared
// memory (all an H100 block can take) with one word, and count the words
// that still hold it in a later kernel's shared memory, which it reads
// without writing.  Shared memory is not cleared between kernels, so a fill
// of every SM before a kernel shows whether that kernel reads a word it did
// not write (tests/test_torch_gpu.py).
//
//   int fill_shared(unsigned word, int blocks, void* stream);
//   int count_shared(unsigned word, int blocks, unsigned long long* count, void* stream);

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMEM = 232448;
constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS) fill_kernel(uint32_t word) {
  extern __shared__ uint32_t s[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  for (int i = threadIdx.x; i < SMEM / 4; i += THREADS)
    asm volatile("st.volatile.shared.u32 [%0], %1;\n" ::"r"(base + 4u * i), "r"(word) : "memory");
}

__global__ void __launch_bounds__(THREADS) count_kernel(uint32_t word,
                                                        unsigned long long* count) {
  extern __shared__ uint32_t s[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  unsigned long long n = 0;
  for (int i = threadIdx.x; i < SMEM / 4; i += THREADS) {
    uint32_t v;
    asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(base + 4u * i) : "memory");
    n += v == word;
  }
  atomicAdd(count, n);
}

template <typename K, typename... Args>
int launch(K kernel, int blocks, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fill_shared(unsigned word, int blocks, void* stream) {
  return launch(fill_kernel, blocks, stream, word);
}

int count_shared(unsigned word, int blocks, void* count, void* stream) {
  return launch(count_kernel, blocks, stream, word, static_cast<unsigned long long*>(count));
}

const char* fill_shared_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
