// The byte order of a u32 -> 4 x int8 bitcast on the card.
//
// Replaces prmers_tpu/tools/probe_bitcast.py:34 (a pallas_call of
// pltpu.bitcast(x, int8) on (8, 128) u32 -> (32, 128) int8), the probe that
// found where Mosaic puts the four bytes of each word among the sublanes.
// Here row 4 * l + b of the output takes byte b of word l as the card
// stores the word in memory (read through a byte pointer, not by shifts),
// so "interleaved" (word-major) order is what a little-endian card gives.
//
// What bounds it on the H100: nothing measurable: 4 KiB in, 4 KiB out, one
// launch. One thread per output byte.

#include <cuda_runtime.h>

namespace {

__global__ void bitcast_kernel(const unsigned int* x, signed char* out,
                               int L, int C) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 4 * L * C) return;
    const int row = i / C, c = i % C;
    const int l = row / 4, b = row % 4;
    const unsigned char* bytes = (const unsigned char*)(x + (size_t)l * C + c);
    out[i] = (signed char)bytes[b];
}

}  // namespace

extern "C" int prmers_probe_bitcast(const unsigned int* x, signed char* out,
                                    int L, int C, void* stream) {
    if (L <= 0 || C <= 0) return -1;
    const int total = 4 * L * C;
    bitcast_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        x, out, L, C);
    return (int)cudaGetLastError();
}
