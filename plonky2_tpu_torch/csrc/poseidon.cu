// Poseidon over Goldilocks, width 12, x^7 S-box: 4 full + 22 partial + 4
// full rounds (reference plonky2/src/hash/poseidon.rs:574-636), and a
// sponge that hashes whole Merkle leaves with it.
//
// Replaces the TPU kernel plonky2_tpu/ops/poseidon_pallas.py permute_cols
// (_poseidon_kernel / _poseidon_kernel_mxu, round logic _rounds).  The TPU
// kernel kept a (12, B) planar u32 layout to fill 128 vector lanes and did
// the MDS as byte-plane matrix-unit dots; neither carries over.  Here each
// thread owns one state in registers and the constants sit in __constant__
// memory (every thread of a warp reads the same one, a broadcast).
//
// Bound on the H100: integer multiplies and, above all, the instructions
// around them (carries, compares, selects); 192 bytes of state in and out
// are far below the memory roofline.  What the design does about it:
//  - the partial rounds run the reference's fast schedule (poseidon.rs:584,
//    partial_first_constant_layer, mds_partial_layer_init, then per round
//    an S-box on lane 0, a 12-term dot product with FAST_PARTIAL_ROUND_
//    W_HATS and an 11-term rank-1 update with FAST_PARTIAL_ROUND_VS).  The
//    canonical schedule spends a full MDS (240 products) on each of the 22
//    rounds in which only lane 0 went through the S-box; the fast one 22
//    64-bit products, so 6,272 32-bit multiplies per permutation against
//    9,088;
//  - a 64-bit product is four IMAD.WIDE.U32 (gl::mul128); a dot product
//    accumulates 128-bit products (plus a small overflow digit) and reduces
//    once, and the rank-1 update's multiply-add reduces once;
//  - the full rounds' MDS multiplies the constants (<= 41) by 32-bit
//    halves with IMAD.WIDE.U32 into 64-bit sums (< 2^41) and reduces each
//    lane once with gl::reduce_halves, which needs no 128-bit reduction.
// The byte-plane int8 tensor-core MDS of the TPU kernel was not tried: on
// this card the fast schedule leaves 8 of the 30 rounds with a full MDS,
// 1,920 of the 6,272 multiplies.
//
// The sponge (hash/hashing.py hash_no_pad; the TPU package ran it as one
// permute_cols launch per rate-8 chunk).  A leaf's permutations are a chain:
// each absorbs the state the previous one left, so a leaf of L elements is
// ceil(L / 8) dependent permutations whatever the card's throughput.  What
// bounds it depends on the shape:
//  - many short leaves (2^18 leaves of 135, the plonk wires): operations,
//    2^18 x 17 permutations; one thread per leaf keeps the card full and
//    issues the fewest instructions per permutation;
//  - few long leaves (2^10 leaves of 2,481, the zkEVM KeccakStark trace):
//    the chain of 311 permutations.  One thread per leaf is 8 blocks on 8
//    of the 132 SMs, each thread one dependent instruction after another.
//    So a group of GROUP = 16 lanes of one warp hashes one leaf: lane l < 12
//    holds state element l.  A full round runs the 12 S-boxes at once and
//    each lane gathers its MDS row's inputs with __shfl_sync; a partial
//    round runs lane 0's S-box beside the other lanes' W_HATS products,
//    sums those by a 4-step xor-shuffle butterfly, broadcasts lane 0's
//    S-box output and makes the VS rank-1 update one multiply-add per lane.
//    The chain per permutation is a fraction of one thread's, and 16 times
//    as many warps run.  Lane-dependent constants sit in shared memory.
//    (Summing the dot product one round ahead, so that no shuffle sits in
//    the S-box's chain, ran 25 % slower: kernel_variants.py
//    "lanes_dot_one_round_ahead".)
//    Lanes 12-15 of a group compute values that no lane reads.
// The wrapper picks the group size from the leaf count (hash/hashing.py
// sponge_group: one thread per leaf where leaves alone fill the card).
// Leaves are read where they lie: the row entry reads leaf j from row j of a
// (leaves, len) array; the column entry reads leaf j from column j of a
// (len, n) array, the layout in which the LDE leaves a committed batch, so
// neighbouring threads (or groups) read neighbouring addresses and no
// transposed copy of the LDE is made.  Each chunk's loads for the next
// permutation are issued before the current one runs in the lane groups;
// one thread per leaf loads each chunk as it absorbs it (a prefetched chunk
// would take 16 more registers; untried).
//
// C interface (launches: kernel launches issued, 1 or 0 when there is no
// work; each returns cudaGetLastError(); group is 1 or 16 lanes per leaf):
//   poseidon_permute(in, out, n, launches, stream) permutes n contiguous
//     states of 12 u64 from in into out (distinct buffers);
//   poseidon_hash_rows(in, out, rows, len, num_outputs, group, launches,
//     stream) hashes each of `rows` contiguous rows of `len` u64 with the
//     overwrite-mode sponge (rate 8: each chunk of up to 8 elements
//     replaces the first lanes of the state, then one permutation; no
//     padding), as hash/hashing.py hash_no_pad does, and writes the first
//     num_outputs (<= 8) lanes of each final state to out (rows,
//     num_outputs).  The state stays in registers from the first chunk to
//     the last;
//   poseidon_hash_cols(in, out, len, n, stride, num_outputs, leaf_order,
//     group, launches, stream) hashes column j of the (len, n) array whose
//     row e starts at in + e * stride, for each j < n, and writes its digest
//     to row reverse_bits(j) of out (n, num_outputs) when leaf_order is 1
//     (n a power of two: the Merkle leaf order of a committed LDE), or to
//     row j when it is 0.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int RATE = 8;
// 8 blocks of 128 threads on an SM (at most 64 registers a thread): 2^17
// states fill the card in one wave, where 72-80 registers took two.
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;
// 6 blocks (80 registers) for the sponge's one-thread-a-leaf kernels:
// fewer spills, and 4-7 % faster at 2^18 leaves of 135 than 8
// (kernel_variants.py "sponge_min_blocks_8").
constexpr int SPONGE_MIN_BLOCKS = 6;
// The sponge's lane groups: GROUP lanes of a warp per leaf, 8 leaves a block.
constexpr int GROUP = 16;
constexpr int GROUP_THREADS = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;

// hash/poseidon_constants.py: FULL_RC holds ALL_ROUND_CONSTANTS of the
// four first and four last rounds; the rest is the fast partial schedule
// (FAST_PARTIAL_FIRST_ROUND_CONSTANT, FAST_PARTIAL_ROUND_CONSTANTS,
// FAST_PARTIAL_ROUND_INITIAL_MATRIX, FAST_PARTIAL_ROUND_VS and
// FAST_PARTIAL_ROUND_W_HATS, row-major).
__constant__ uint64_t FULL_RC[96] = {
    0xb585f766f2144405ull, 0x7746a55f43921ad7ull, 0xb2fb0d31cee799b4ull, 0x0f6760a4803427d7ull,
    0xe10d666650f4e012ull, 0x8cae14cb07d09bf1ull, 0xd438539c95f63e9full, 0xef781c7ce35b4c3dull,
    0xcdc4a239b0c44426ull, 0x277fa208bf337bffull, 0xe17653a29da578a1ull, 0xc54302f225db2c76ull,
    0x86287821f722c881ull, 0x59cd1a8a41c18e55ull, 0xc3b919ad495dc574ull, 0xa484c4c5ef6a0781ull,
    0x308bbd23dc5416ccull, 0x6e4a40c18f30c09cull, 0x9a2eedb70d8f8cfaull, 0xe360c6e0ae486f38ull,
    0xd5c7718fbfc647fbull, 0xc35eae071903ff0bull, 0x849c2656969c4be7ull, 0xc0572c8c08cbbbadull,
    0xe9fa634a21de0082ull, 0xf56f6d48959a600dull, 0xf7d713e806391165ull, 0x8297132b32825dafull,
    0xad6805e0e30b2c8aull, 0xac51d9f5fcf8535eull, 0x502ad7dc18c2ad87ull, 0x57a1550c110b3041ull,
    0x66bbd30e6ce0e583ull, 0x0da2abef589d644eull, 0xf061274fdb150d61ull, 0x28b8ec3ae9c29633ull,
    0x92a756e67e2b9413ull, 0x70e741ebfee96586ull, 0x019d5ee2af82ec1cull, 0x6f6f2ed772466352ull,
    0x7cf416cfe7e14ca1ull, 0x61df517b86a46439ull, 0x85dc499b11d77b75ull, 0x4b959b48b9c10733ull,
    0xe8be3e5da8043e57ull, 0xf5c0bc1de6da8699ull, 0x40b12cbf09ef74bfull, 0xa637093ecb2ad631ull,
    0x475cd3205a3bdcdeull, 0x18a42105c31b7e88ull, 0x023e7414af663068ull, 0x15147108121967d7ull,
    0xe4a3dff1d7d6fef9ull, 0x01a8d1a588085737ull, 0x11b4c74eda62beefull, 0xe587cc0d69a73346ull,
    0x1ff7327017aa2a6eull, 0x594e29c42473d06bull, 0xf6f31db1899b12d5ull, 0xc02ac5e47312d3caull,
    0xe70201e960cb78b8ull, 0x6f90ff3b6a65f108ull, 0x42747a7245e7fa84ull, 0xd1f507e43ab749b2ull,
    0x1c86d265f15750cdull, 0x3996ce73dd832c1cull, 0x8e7fba02983224bdull, 0xba0dec7103255dd4ull,
    0x9e9cbd781628fc5bull, 0xdae8645996edd6a5ull, 0xdebe0853b1a1d378ull, 0xa49229d24d014343ull,
    0x7be5b9ffda905e1cull, 0xa3c95eaec244aa30ull, 0x0230bca8f4df0544ull, 0x4135c2bebfe148c6ull,
    0x166fc0cc438a3c72ull, 0x3762b59a8ae83efaull, 0xe8928a4c89114750ull, 0x2a440b51a4945ee5ull,
    0x80cefd2b7d99ff83ull, 0xbb9879c6e61fd62aull, 0x6e7c8f1a84265034ull, 0x164bb2de1bbeddc8ull,
    0xf3c12fe54d5c653bull, 0x40b9e922ed9771e2ull, 0x551f5b0fbe7b1840ull, 0x25032aa7c4cb1811ull,
    0xaaed34074b164346ull, 0x8ffd96bbf9c9c81dull, 0x70fc91eb5937085cull, 0x7f795e2a5f915440ull,
    0x4543d9df5476d3cbull, 0xf172d73e004fc90dull, 0xdfd1c4febcc81238ull, 0xbc8dfb627fe558fcull,
};

__constant__ uint64_t FIRST_RC[12] = {
    0x3cc3f892184df408ull, 0xe993fd841e7e97f1ull, 0xf2831d3575f0f3afull, 0xd2500e0a350994caull,
    0xc5571f35d7288633ull, 0x91d89c5184109a02ull, 0xf37f925d04e5667bull, 0x2d6e448371955a69ull,
    0x740ef19ce01398a1ull, 0x694d24c0752fdf45ull, 0x60936af96ee2f148ull, 0xc33448feadc78f0cull,
};

__constant__ uint64_t PARTIAL_RC[22] = {
    0x74cb2e819ae421abull, 0xd2559d2370e7f663ull, 0x62bf78acf843d17cull, 0xd5ab7b67e14d1fb4ull,
    0xb9fe2ae6e0969bdcull, 0xe33fdf79f92a10e8ull, 0x0ea2bb4c2b25989bull, 0xca9121fbf9d38f06ull,
    0xbdd9b0aa81f58fa4ull, 0x83079fa4ecf20d7eull, 0x650b838edfcc4ad3ull, 0x77180c88583c76acull,
    0xaf8c20753143a180ull, 0xb8ccfe9989a39175ull, 0x954a1729f60cc9c5ull, 0xdeb5b550c4dca53bull,
    0xf01bb0b00f77011eull, 0xa1ebb404b676afd9ull, 0x860b6e1597a0173eull, 0x308bb65a036acbceull,
    0x1aca78f31c97c876ull, 0x0000000000000000ull,
};

__constant__ uint64_t INIT[121] = {
    0x80772dc2645b280bull, 0xdc927721da922cf8ull, 0xc1978156516879adull, 0x90e80c591f48b603ull,
    0x3a2432625475e3aeull, 0x00a2d4321cca94feull, 0x77736f524010c932ull, 0x904d3f2804a36c54ull,
    0xbf9b39e28a16f354ull, 0x3a1ded54a6cd058bull, 0x42392870da5737cfull, 0xe796d293a47a64cbull,
    0xb124c33152a2421aull, 0x0ee5dc0ce131268aull, 0xa9032a52f930fae6ull, 0x7e33ca8c814280deull,
    0xad11180f69a8c29eull, 0xc75ac6d5b5a10ff3ull, 0xf0674a8dc5a387ecull, 0xb36d43120eaa5e2bull,
    0x6f232aab4b533a25ull, 0x3a1ded54a6cd058bull, 0xdcedab70f40718baull, 0x14a4a64da0b2668full,
    0x4715b8e5ab34653bull, 0x1e8916a99c93a88eull, 0xbba4b5d86b9a3b2cull, 0xe76649f9bd5d5c2eull,
    0xaf8e2518a1ece54dull, 0xdcda1344cdca873full, 0xcd080204256088e5ull, 0xb36d43120eaa5e2bull,
    0xbf9b39e28a16f354ull, 0xf4a437f2888ae909ull, 0xc537d44dc2875403ull, 0x7f68007619fd8ba9ull,
    0xa4911db6a32612daull, 0x2f7e9aade3fdaec1ull, 0xe7ffd578da4ea43dull, 0x43a608e7afa6b5c2ull,
    0xca46546aa99e1575ull, 0xdcda1344cdca873full, 0xf0674a8dc5a387ecull, 0x904d3f2804a36c54ull,
    0xf97abba0dffb6c50ull, 0x5e40f0c9bb82aab5ull, 0x5996a80497e24a6bull, 0x07084430a7307c9aull,
    0xad2f570a5b8545aaull, 0xab7f81fef4274770ull, 0xcb81f535cf98c9e9ull, 0x43a608e7afa6b5c2ull,
    0xaf8e2518a1ece54dull, 0xc75ac6d5b5a10ff3ull, 0x77736f524010c932ull, 0x7f8e41e0b0a6cdffull,
    0x4b1ba8d40afca97dull, 0x623708f28fca70e8ull, 0xbf150dc4914d380full, 0xc26a083554767106ull,
    0x753b8b1126665c22ull, 0xab7f81fef4274770ull, 0xe7ffd578da4ea43dull, 0xe76649f9bd5d5c2eull,
    0xad11180f69a8c29eull, 0x00a2d4321cca94feull, 0x726af914971c1374ull, 0x1d7f8a2cce1a9d00ull,
    0x18737784700c75cdull, 0x7fb45d605dd82838ull, 0x862361aeab0f9b6eull, 0xc26a083554767106ull,
    0xad2f570a5b8545aaull, 0x2f7e9aade3fdaec1ull, 0xbba4b5d86b9a3b2cull, 0x7e33ca8c814280deull,
    0x3a2432625475e3aeull, 0x64dd936da878404dull, 0x4db9a2ead2bd7262ull, 0xbe2e19f6d07f1a83ull,
    0x02290fe23c20351aull, 0x7fb45d605dd82838ull, 0xbf150dc4914d380full, 0x07084430a7307c9aull,
    0xa4911db6a32612daull, 0x1e8916a99c93a88eull, 0xa9032a52f930fae6ull, 0x90e80c591f48b603ull,
    0x85418a9fef8a9890ull, 0xd8a2eb7ef5e707adull, 0xbfe85ababed2d882ull, 0xbe2e19f6d07f1a83ull,
    0x18737784700c75cdull, 0x623708f28fca70e8ull, 0x5996a80497e24a6bull, 0x7f68007619fd8ba9ull,
    0x4715b8e5ab34653bull, 0x0ee5dc0ce131268aull, 0xc1978156516879adull, 0x156048ee7a738154ull,
    0x91f7562377e81df5ull, 0xd8a2eb7ef5e707adull, 0x4db9a2ead2bd7262ull, 0x1d7f8a2cce1a9d00ull,
    0x4b1ba8d40afca97dull, 0x5e40f0c9bb82aab5ull, 0xc537d44dc2875403ull, 0x14a4a64da0b2668full,
    0xb124c33152a2421aull, 0xdc927721da922cf8ull, 0xd841e8ef9dde8ba0ull, 0x156048ee7a738154ull,
    0x85418a9fef8a9890ull, 0x64dd936da878404dull, 0x726af914971c1374ull, 0x7f8e41e0b0a6cdffull,
    0xf97abba0dffb6c50ull, 0xf4a437f2888ae909ull, 0xdcedab70f40718baull, 0xe796d293a47a64cbull,
    0x80772dc2645b280bull,
};

__constant__ uint64_t VS[242] = {
    0x94877900674181c3ull, 0xc6c67cc37a2a2bbdull, 0xd667c2055387940full, 0x0ba63a63e94b5ff0ull,
    0x99460cc41b8f079full, 0x7ff02375ed524bb3ull, 0xea0870b47a8caf0eull, 0xabcad82633b7bc9dull,
    0x3b8d135261052241ull, 0xfb4515f5e5b0d539ull, 0x3ee8011c2b37f77cull, 0x0adef3740e71c726ull,
    0xa37bf67c6f986559ull, 0xc6b16f7ed4fa1b00ull, 0x6a065da88d8bfc3cull, 0x4cabc0916844b46full,
    0x407faac0f02e78d1ull, 0x07a786d9cf0852cfull, 0x42433fb6949a629aull, 0x891682a147ce43b0ull,
    0x26cfd58e7b003b55ull, 0x2bbf0ed7b657acb3ull, 0x481ac7746b159c67ull, 0xe367de32f108e278ull,
    0x73f260087ad28becull, 0x5cfc82216bc1bdcaull, 0xcaccc870a2663a0eull, 0xdb69cd7b4298c45dull,
    0x7bc9e0c57243e62dull, 0x3cc51c5d368693aeull, 0x366b4e8cc068895bull, 0x2bd18715cdabbca4ull,
    0xa752061c4f33b8cfull, 0xb22d2432b72d5098ull, 0x9e18a487f44d2fe4ull, 0x4b39e14ce22abd3cull,
    0x9e77fde2eb315e0dull, 0xca5e0385fe67014dull, 0x0c2cb99bf1b6bddbull, 0x99ec1cd2a4460bfeull,
    0x8577a815a2ff843full, 0x7d80a6b4fd6518a5ull, 0xeb6c67123eab62cbull, 0x8f7851650eca21a5ull,
    0x11ba9a1b81718c2aull, 0x9f7d798a3323410cull, 0xa821855c8c1cf5e5ull, 0x535e8d6fac0031b2ull,
    0x404e7c751b634320ull, 0xa729353f6e55d354ull, 0x4db97d92e58bb831ull, 0xb53926c27897bf7dull,
    0x965040d52fe115c5ull, 0x9565fa41ebd31fd7ull, 0xaae4438c877ea8f4ull, 0x37f4e36af6073c6eull,
    0x4edc0918210800e9ull, 0xc44998e99eae4188ull, 0x9f4310d05d068338ull, 0x9ec7fe4350680f29ull,
    0xc5b2c1fdc0b50874ull, 0xa01920c5ef8b2ebeull, 0x59fa6f8bd91d58baull, 0x8bfc9eb89b515a82ull,
    0xbe86a7a2555ae775ull, 0xcbb8bbaa3810babfull, 0x577f9a9e7ee3f9c2ull, 0x88c522b949ace7b1ull,
    0x82f07007c8b72106ull, 0x8283d37c6675b50eull, 0x98b074d9bbac1123ull, 0x75c56fb7758317c1ull,
    0xfed24e206052bc72ull, 0x26d7c3d1bc07dae5ull, 0xf88c5e441e28dbb4ull, 0x4fe27f9f96615270ull,
    0x514d4ba49c2b14feull, 0xf02a3ac068ee110bull, 0x0a3630dafb8ae2d7ull, 0xce0dc874eaf9b55cull,
    0x9a95f6cff5b55c7eull, 0x626d76abfed00c7bull, 0xa0c1cf1251c204adull, 0xdaebd3006321052cull,
    0x3d4bd48b625a8065ull, 0x7f1e584e071f6ed2ull, 0x720574f0501caed3ull, 0xe3260ba93d23540aull,
    0xab1cbd41d8c1e335ull, 0x9322ed4c0bc2df01ull, 0x51c3c0983d4284e5ull, 0x94178e291145c231ull,
    0xfd0f1a973d6b2085ull, 0xd427ad96e2b39719ull, 0x8a52437fecaac06bull, 0xdc20ee4b8c4c9a80ull,
    0xa2c98e9549da2100ull, 0x1603fe12613db5b6ull, 0x0e174929433c5505ull, 0x3d4eab2b8ef5f796ull,
    0xcfff421583896e22ull, 0x4143cb32d39ac3d9ull, 0x22365051b78a5b65ull, 0x6f7fd010d027c9b6ull,
    0xd9dd36fba77522abull, 0xa44cf1cb33e37165ull, 0x3fc83d3038c86417ull, 0xc4588d418e88d270ull,
    0xce1320f10ab80fe2ull, 0xdb5eadbbec18de5dull, 0x1183dfce7c454afdull, 0x21cea4aa3d3ed949ull,
    0x0fce6f70303f2304ull, 0x19557d34b55551beull, 0x4c56f689afc5bbc9ull, 0xa1e920844334f944ull,
    0xbad66d423d2ec861ull, 0xf318c785dc9e0479ull, 0x99e2032e765ddd81ull, 0x400ccc9906d66f45ull,
    0xe1197454db2e0dd9ull, 0x84d1ecc4d53d2ff1ull, 0xd8af8b9ceb4e11b6ull, 0x335856bb527b52f4ull,
    0xc756f17fb59be595ull, 0xc0654e4ea5553a78ull, 0x9e9a46b61f2ea942ull, 0x14fc8b5b3b809127ull,
    0xd7009f0f103be413ull, 0x3e0ee7b7a9fb4601ull, 0xa74e888922085ed7ull, 0xe80a7cde3d4ac526ull,
    0x238aa6daa612186dull, 0x9137a5c630bad4b4ull, 0xc7db3817870c5edaull, 0x217e4f04e5718dc9ull,
    0xcae814e2817bd99dull, 0xe3292e7ab770a8baull, 0x7bb36ef70b6b9482ull, 0x3c7835fb85bca2d3ull,
    0xfe2cdf8ee3c25e86ull, 0x61b3915ad7274b20ull, 0xeab75ca7c918e4efull, 0xd6e15ffc055e154eull,
    0xec67881f381a32bfull, 0xfbb1196092bf409cull, 0xdc9d2e07830ba226ull, 0x0698ef3245ff7988ull,
    0x194fae2974f8b576ull, 0x7a5d9bea6ca4910eull, 0x7aebfea95ccdd1c9ull, 0xf9bd38a67d5f0e86ull,
    0xfa65539de65492d8ull, 0xf0dfcbe7653ff787ull, 0x0bd87ad390420258ull, 0x0ad8617bca9e33c8ull,
    0x0c00ad377a1e2666ull, 0x0ac6fc58b3f0518full, 0x0c0cc8a892cc4173ull, 0x0c210accb117bc21ull,
    0x0b73630dbb46ca18ull, 0x0c8be4920cbd4a54ull, 0x0bfe877a21be1690ull, 0x0ae790559b0ded81ull,
    0x0bf50db2f8d6ce31ull, 0x000cf29427ff7c58ull, 0x000bd9b3cf49eec8ull, 0x000d1dc8aa81fb26ull,
    0x000bc792d5c394efull, 0x000d2ae0b2266453ull, 0x000d413f12c496c1ull, 0x000c84128cfed618ull,
    0x000db5ebd48fc0d4ull, 0x000d1b77326dcb90ull, 0x000beb0ccc145421ull, 0x000d10e5b22b11d1ull,
    0x00000e24c99adad8ull, 0x00000cf389ed4bc8ull, 0x00000e580cbf6966ull, 0x00000cde5fd7e04full,
    0x00000e63628041b3ull, 0x00000e7e81a87361ull, 0x00000dabe78f6d98ull, 0x00000efb14cac554ull,
    0x00000e5574743b10ull, 0x00000d05709f42c1ull, 0x00000e4690c96af1ull, 0x0000000f7157bc98ull,
    0x0000000e3006d948ull, 0x0000000fa65811e6ull, 0x0000000e0d127e2full, 0x0000000fc18bfe53ull,
    0x0000000fd002d901ull, 0x0000000eed6461d8ull, 0x0000001068562754ull, 0x0000000fa0236f50ull,
    0x0000000e3af13ee1ull, 0x0000000fa460f6d1ull, 0x0000000011131738ull, 0x000000000f56d588ull,
    0x0000000011050f86ull, 0x000000000f848f4full, 0x00000000111527d3ull, 0x00000000114369a1ull,
    0x00000000106f2f38ull, 0x0000000011e2ca94ull, 0x00000000110a29f0ull, 0x000000000fa9f5c1ull,
    0x0000000010f625d1ull, 0x000000000011f718ull, 0x000000000010b6c8ull, 0x0000000000134a96ull,
    0x000000000010cf7full, 0x0000000000124d03ull, 0x000000000013f8a1ull, 0x0000000000117c58ull,
    0x0000000000132c94ull, 0x0000000000134fc0ull, 0x000000000010a091ull, 0x0000000000128961ull,
    0x0000000000001300ull, 0x0000000000001750ull, 0x000000000000114eull, 0x000000000000131full,
    0x000000000000167bull, 0x0000000000001371ull, 0x0000000000001230ull, 0x000000000000182cull,
    0x0000000000001368ull, 0x0000000000000f31ull, 0x00000000000015c9ull, 0x0000000000000014ull,
    0x0000000000000022ull, 0x0000000000000012ull, 0x0000000000000027ull, 0x000000000000000dull,
    0x000000000000000dull, 0x000000000000001cull, 0x0000000000000002ull, 0x0000000000000010ull,
    0x0000000000000029ull, 0x000000000000000full,
};

__constant__ uint64_t W_HATS[242] = {
    0x3d999c961b7c63b0ull, 0x814e82efcd172529ull, 0x2421e5d236704588ull, 0x887af7d4dd482328ull,
    0xa5e9c291f6119b27ull, 0xbdc52b2676a4b4aaull, 0x64832009d29bcf57ull, 0x09c4155174a552ccull,
    0x463f9ee03d290810ull, 0xc810936e64982542ull, 0x043b1c289f7bc3acull, 0x673655aae8be5a8bull,
    0xd510fe714f39fa10ull, 0x2c68a099b51c9e73ull, 0xa667bfa9aa96999dull, 0x4d67e72f063e2108ull,
    0xf84dde3e6acda179ull, 0x40f9cc8c08f80981ull, 0x5ead032050097142ull, 0x6591b02092d671bbull,
    0x00e18c71963dd1b7ull, 0x8a21bcd24a14218aull, 0x202800f4addbdc87ull, 0xe4b5bdb1cc3504ffull,
    0xbe32b32a825596e7ull, 0x8e0f68c5dc223b9aull, 0x58022d9e1c256ce3ull, 0x584d29227aa073acull,
    0x8b9352ad04bef9e7ull, 0xaead42a3f445ecbfull, 0x3c667a1d833a3ccaull, 0xda6f61838efa1ffeull,
    0xe8f749470bd7c446ull, 0xc5b85bab9e5b3869ull, 0x45245258aec51cf7ull, 0x16e6b8e68b931830ull,
    0xe2ae0f051418112cull, 0x0470e26a0093a65bull, 0x6bef71973a8146edull, 0x119265be51812dafull,
    0xb0be7356254bea2eull, 0x8584defff7589bd7ull, 0x3c5fe4aeb1fb52baull, 0x9e7cd88acf543a5eull,
    0x179be4bba87f0a8cull, 0xacf63d95d8887355ull, 0x6696670196b0074full, 0xd99ddf1fe75085f9ull,
    0xc2597881fef0283bull, 0xcf48395ee6c54f14ull, 0x15226a8e4cd8d3b6ull, 0xc053297389af5d3bull,
    0x2c08893f0d1580e2ull, 0x0ed3cbcff6fcc5baull, 0xc82f510ecf81f6d0ull, 0x94b06183acb715ccull,
    0x500392ed0d431137ull, 0x861cc95ad5c86323ull, 0x05830a443f86c4acull, 0x3b68225874a20a7cull,
    0x10b3309838e236fbull, 0x9b77fc8bcd559e2cull, 0xbdecf5e0cb9cb213ull, 0x30276f1221ace5faull,
    0x7935dd342764a144ull, 0xeac6db520bb03708ull, 0x7186a80551025f8full, 0x622247557e9b5371ull,
    0xc4cbe326d1ad9742ull, 0x55f1523ac6a23ea2ull, 0xa13dfe77a3d52f53ull, 0xe30750b6301c0452ull,
    0x08bd488070a3a32bull, 0xcd800caef5b72ae3ull, 0x83329c90f04233ceull, 0xb5b99e6664a0a3eeull,
    0x6b0731849e200a7full, 0xec3fabc192b01799ull, 0x382b38cee8ee5375ull, 0x3bfb6c3f0e616572ull,
    0x514abd0cf6c7bc86ull, 0x47521b1361dcc546ull, 0x178093843f863d14ull, 0xad1003c5d28918e7ull,
    0x738450e42495bc81ull, 0xaf947c59af5e4047ull, 0x4653fb0685084ef2ull, 0x057fde2062ae35bfull,
    0xe376678d843ce55eull, 0x66f3860d7514e7fcull, 0x7817f3dfff8b4ffaull, 0x3929624a9def725bull,
    0x0126ca37f215a80aull, 0xfce2f5d02762a303ull, 0x1bc927375febbad7ull, 0x85b481e5243f60bfull,
    0x2d3c5f42a39c91a0ull, 0x0811719919351ae8ull, 0xf669de0add993131ull, 0x7de38bae084da92dull,
    0x5b848442237e8a9bull, 0xf6c705da84d57310ull, 0x31e6a4bdb6a49017ull, 0x889489706e5c5c0full,
    0x0e4a205459692a1bull, 0xbac3fa75ee26f299ull, 0x5f5894f4057d755eull, 0xb0dc3ecd724bb076ull,
    0x5e34d8554a6452baull, 0x04f78fd8c1fdcc5full, 0x4dd19c38779512eaull, 0xdb79ba02704620e9ull,
    0x92a29a3675a5d2beull, 0xd5177029fe495166ull, 0xd32b3298a13330c1ull, 0x251c4a3eb2c5f8fdull,
    0xe1c48b26e0d98825ull, 0x3301d3362a4ffccbull, 0x09bb6c88de8cd178ull, 0xdc05b676564f538aull,
    0x60192d883e473feeull, 0x16b9774801ac44a0ull, 0x3cb8411e786d3c8eull, 0xa86e9cf505072491ull,
    0x0178928152e109aeull, 0x5317b905a6e1ab7bull, 0xda20b3be7f53d59full, 0xcb97dedecebee9adull,
    0x4bd545218c59f58dull, 0x77dc8d856c05a44aull, 0x87948589e4f243fdull, 0x7e5217af969952c2ull,
    0xbc58987d06a84e4dull, 0x0b5d420244c9cae3ull, 0xa3c4711b938c02c0ull, 0x3aace640a3e03990ull,
    0x865a0f3249aacd8aull, 0x8d00b2a7dbed06c7ull, 0x6eacb905beb7e2f8ull, 0x045322b216ec3ec7ull,
    0xeb9de00d594828e6ull, 0x088c5f20df9e5c26ull, 0xf555f4112b19781full, 0xa8cedbff1813d3a7ull,
    0x50dcaee0fd27d164ull, 0xf1cb02417e23bd82ull, 0xfaf322786e2abe8bull, 0x937a4315beb5d9b6ull,
    0x1b18992921a11d85ull, 0x7d66c4368b3c497bull, 0x0e7946317a6b4e99ull, 0xbe4430134182978bull,
    0x3771e82493ab262dull, 0xa671690d8095ce82ull, 0xb035585f6e929d9dull, 0xba1579c7e219b954ull,
    0xcb201cf846db4ba3ull, 0x287bf9177372cf45ull, 0xa350e4f61147d0a6ull, 0xd5d0ecfb50bcff99ull,
    0x2e166aa6c776ed21ull, 0xe1e66c991990e282ull, 0x662b329b01e7bb38ull, 0x8aa674b36144d9a9ull,
    0xcbabf78f97f95e65ull, 0xeec24b15a06b53feull, 0xc8a7aa07c5633533ull, 0xefe9c6fa4311ad51ull,
    0xb9173f13977109a1ull, 0x69ce43c9cc94aedcull, 0xecf623c9cd118815ull, 0x28625def198c33c7ull,
    0xccfc5f7de5c3636aull, 0xf5e6c40f1621c299ull, 0xcec0e58c34cb64b1ull, 0xa868ea113387939full,
    0xd8dddbdc5ce4ef45ull, 0xacfc51de8131458cull, 0x146bb3c0fe499ac0ull, 0x9e65309f15943903ull,
    0x80d0ad980773aa70ull, 0xf97817d4ddbf0607ull, 0xe4626620a75ba276ull, 0x0dfdc7fd6fc74f66ull,
    0xf464864ad6f2bb93ull, 0x02d55e52a5d44414ull, 0xdd8de62487c40925ull, 0xc15acf44759545a3ull,
    0xcbfdcf39869719d4ull, 0x33f62042e2f80225ull, 0x2599c5ead81d8fa3ull, 0x0b306cb6c1d7c8d0ull,
    0x658c80d3df3729b1ull, 0xe8d1b2b21b41429cull, 0xa1b67f09d4b3ccb8ull, 0x0e1adf8b84437180ull,
    0x0d593a5e584af47bull, 0xa023d94c56e151c7ull, 0x49026cc3a4afc5a6ull, 0xe06dff00ab25b91bull,
    0x0ab38c561e8850ffull, 0x92c3c8275e105eebull, 0xb65256e546889bd0ull, 0x3c0468236ea142f6ull,
    0xee61766b889e18f2ull, 0xa206f41b12c30415ull, 0x02fe9d756c9f12d1ull, 0xe9633210630cbf12ull,
    0x1ffea9fe85a0b0b1ull, 0x81d1ae8cc50240f3ull, 0xf4c77a079a4607d7ull, 0xed446b2315e3efc1ull,
    0x0b0a6b70915178c3ull, 0xb11ff3e089f15d9aull, 0x1d4dba0b7ae9cc18ull, 0x65d74e2f43b48d05ull,
    0xa2df8c6b8ae0804aull, 0xa4e6f0a8c33348a6ull, 0xc0a26efc7be5669bull, 0xa6b6582c547d0d60ull,
    0x84afc741f1c13213ull, 0x2f8f43734fc906f3ull, 0xde682d72da0a02d9ull, 0x0bb005236adb9ef2ull,
    0x5bdf35c10a8b5624ull, 0x0739a8a343950010ull, 0x52f515f44785cfbcull, 0xcbaf4e5d82856c60ull,
    0xac9ea09074e3e150ull, 0x8f0fa011a2035fb0ull, 0x1a37905d8450904aull, 0x3abeb80def61cc85ull,
    0x9d19c9dd4eac4133ull, 0x075a652d9641a985ull, 0x9daf69ae1b67e667ull, 0x364f71da77920a18ull,
    0x50bd769f745c95b1ull, 0xf223d1180dbbf3fcull, 0x2f885e584e04aa99ull, 0xb69a0fa70aea684aull,
    0x09584acaa6e062a0ull, 0x0bc051640145b19bull,
};


// MDS_MATRIX_CIRC (hash/poseidon_constants.py); MDS_MATRIX_DIAG is 8 at
// lane 0 and 0 elsewhere.
__device__ __forceinline__ uint64_t circ(int i) {
  switch (i) {
    case 0: return 17; case 1: return 15; case 2: return 41; case 3: return 16;
    case 4: return 2;  case 5: return 28; case 6: return 13; case 7: return 13;
    case 8: return 39; case 9: return 18; case 10: return 34; default: return 20;
  }
}
constexpr uint64_t MDS00 = 17 + 8;  // CIRC[0] + DIAG[0]

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl::mul(x, x);
  uint64_t x4 = gl::mul(x2, x2);
  return gl::mul(gl::mul(x, x2), x4);
}

// out[r] = sum_i CIRC[i] s[(r + i) % 12] + DIAG[r] s[r], summed exactly on
// the 32-bit halves of the lanes and reduced once per lane.
__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; j++) {
    lo[j] = (uint32_t)s[j];
    hi[j] = (uint32_t)(s[j] >> 32);
  }
#pragma unroll
  for (int r = 0; r < WIDTH; r++) {
    uint64_t cl = 0, ch = 0;
#pragma unroll
    for (int i = 0; i < WIDTH; i++) {
      cl += circ(i) * lo[(r + i) % WIDTH];
      ch += circ(i) * hi[(r + i) % WIDTH];
    }
    if (r == 0) {
      cl += 8ull * lo[0];
      ch += 8ull * hi[0];
    }
    s[r] = gl::reduce_halves(cl, ch);
  }
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int j = 0; j < WIDTH; j++) s[j] = sbox(gl::add(s[j], FULL_RC[r * WIDTH + j]));
  mds(s);
}

// A sum of 128-bit products: value = top 2^128 + hi 2^64 + lo.
struct Acc {
  uint64_t lo = 0, hi = 0;
  uint32_t top = 0;
  __device__ __forceinline__ void add_product(uint64_t a, uint64_t b) {
    uint64_t ph, pl;
    gl::mul128(a, b, ph, pl);
    lo += pl;
    ph += lo < pl;       // ph <= 2^64 - 2, no wrap
    hi += ph;
    top += hi < ph;
  }
  // 2^128 = -2^32 mod p
  __device__ __forceinline__ uint64_t reduce() const {
    return gl::sub(gl::reduce128(hi, lo), (uint64_t)top << 32);
  }
};

__device__ __forceinline__ void partial_rounds(uint64_t s[WIDTH]) {
#pragma unroll
  for (int j = 0; j < WIDTH; j++) s[j] = gl::add(s[j], FIRST_RC[j]);
  // mds_partial_layer_init: lane 0 passes, lanes 1..11 through an 11x11
  // matrix (out[c] = sum_r s[r] INIT[r-1][c-1])
  {
    uint64_t t[WIDTH];
#pragma unroll
    for (int c = 1; c < WIDTH; c++) {
      Acc acc;
#pragma unroll
      for (int r = 1; r < WIDTH; r++)
        acc.add_product(s[r], INIT[(r - 1) * (WIDTH - 1) + (c - 1)]);
      t[c] = acc.reduce();
    }
#pragma unroll
    for (int c = 1; c < WIDTH; c++) s[c] = t[c];
  }
#pragma unroll 1
  for (int r = 0; r < PARTIAL; r++) {
    const uint64_t s0 = gl::add(sbox(s[0]), PARTIAL_RC[r]);
    const uint64_t* w = W_HATS + r * (WIDTH - 1);
    const uint64_t* v = VS + r * (WIDTH - 1);
    Acc acc;
    acc.add_product(s0, MDS00);
#pragma unroll
    for (int i = 1; i < WIDTH; i++) acc.add_product(s[i], w[i - 1]);
#pragma unroll
    for (int i = 1; i < WIDTH; i++) s[i] = gl::mul_add(s0, v[i - 1], s[i]);
    s[0] = acc.reduce();
  }
}

__device__ __forceinline__ void permute(uint64_t s[WIDTH]) {
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; r++) full_round(s, r);
  partial_rounds(s);
#pragma unroll 1
  for (int r = HALF_FULL; r < 2 * HALF_FULL; r++) full_round(s, r);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
poseidon_kernel(const uint64_t* __restrict__ in,
                                uint64_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; j++) s[j] = in[i * WIDTH + j];
  permute(s);
#pragma unroll
  for (int j = 0; j < WIDTH; j++) out[i * WIDTH + j] = s[j];
}

// -- the sponge -------------------------------------------------------------

// Leaf j of a sponge launch.  Rows: element e at in[j * stride + e].
// Columns: element e at in[e * stride + j].  Its digest goes to row slot(j)
// of out (leaves, num_outputs).
struct Leaves {
  const uint64_t* in;
  uint64_t* out;
  int64_t count, len, stride;
  int num_outputs;
  int log_order;  // log2(count) when digests go in leaf order, else -1

  template <bool COLS>
  __device__ __forceinline__ const uint64_t* leaf(int64_t j) const {
    return in + (COLS ? j : j * stride);
  }
  template <bool COLS>
  __device__ __forceinline__ int64_t step() const {
    return COLS ? stride : 1;
  }
  __device__ __forceinline__ int64_t slot(int64_t j) const {
    if (log_order <= 0) return j;
    return (int64_t)(__brevll((unsigned long long)j) >> (64 - log_order));
  }
};

// One thread per leaf, the whole state in registers.
template <bool COLS>
__device__ __forceinline__ void sponge_thread(const Leaves& L) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L.count) return;
  const uint64_t* leaf = L.leaf<COLS>(j);
  const int64_t step = L.step<COLS>();
  uint64_t s[WIDTH];
#pragma unroll
  for (int e = 0; e < WIDTH; e++) s[e] = 0;
  for (int64_t start = 0; start < L.len; start += RATE) {
    const int64_t k = L.len - start;
#pragma unroll
    for (int e = 0; e < RATE; e++)
      if (e < k) s[e] = leaf[(start + e) * step];
    permute(s);
  }
  const int64_t o = L.slot(j) * L.num_outputs;
#pragma unroll
  for (int e = 0; e < RATE; e++)
    if (e < L.num_outputs) L.out[o + e] = s[e];
}

// The constants whose index depends on the lane, for the lane groups.
struct LaneConsts {
  uint64_t full_rc[2 * HALF_FULL * WIDTH];
  uint64_t first_rc[WIDTH];
  uint64_t init[(WIDTH - 1) * (WIDTH - 1)];
  uint64_t vs[PARTIAL * (WIDTH - 1)];
  uint64_t w_hats[PARTIAL * (WIDTH - 1)];
};

__device__ __forceinline__ void load_lane_consts(LaneConsts& c) {
  for (int i = threadIdx.x; i < 2 * HALF_FULL * WIDTH; i += blockDim.x)
    c.full_rc[i] = FULL_RC[i];
  for (int i = threadIdx.x; i < WIDTH; i += blockDim.x) c.first_rc[i] = FIRST_RC[i];
  for (int i = threadIdx.x; i < (WIDTH - 1) * (WIDTH - 1); i += blockDim.x)
    c.init[i] = INIT[i];
  for (int i = threadIdx.x; i < PARTIAL * (WIDTH - 1); i += blockDim.x) {
    c.vs[i] = VS[i];
    c.w_hats[i] = W_HATS[i];
  }
  __syncthreads();
}

// Lane src's value within this lane's group (src taken mod GROUP).
__device__ __forceinline__ uint64_t from_lane(uint64_t v, int src) {
  const uint32_t lo = __shfl_sync(FULL_MASK, (uint32_t)v, src, GROUP);
  const uint32_t hi = __shfl_sync(FULL_MASK, (uint32_t)(v >> 32), src, GROUP);
  return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ uint64_t from_lane_xor(uint64_t v, int mask) {
  const uint32_t lo = __shfl_xor_sync(FULL_MASK, (uint32_t)v, mask, GROUP);
  const uint32_t hi = __shfl_xor_sync(FULL_MASK, (uint32_t)(v >> 32), mask, GROUP);
  return ((uint64_t)hi << 32) | lo;
}

// A full round on a group: lane l < 12 holds state element l in x.  The
// MDS row of lane l is sum_i CIRC[i] s[(l + i) % 12] (+ 8 s[0] on lane 0),
// gathered from the other lanes on 32-bit halves as mds() sums them, in two
// sums per half so that the adds do not form one chain.
__device__ __forceinline__ uint64_t full_round_lanes(uint64_t x, int l,
                                                     uint64_t rc) {
  x = sbox(gl::add(x, rc));
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  uint64_t cl[2] = {circ(0) * lo, 0}, ch[2] = {circ(0) * hi, 0};
#pragma unroll
  for (int i = 1; i < WIDTH; i++) {
    const int src = l + i - (l + i >= WIDTH ? WIDTH : 0);
    cl[i & 1] += circ(i) * __shfl_sync(FULL_MASK, lo, src, GROUP);
    ch[i & 1] += circ(i) * __shfl_sync(FULL_MASK, hi, src, GROUP);
  }
  if (l == 0) {
    cl[0] += 8ull * lo;
    ch[0] += 8ull * hi;
  }
  return gl::reduce_halves(cl[0] + cl[1], ch[0] + ch[1]);
}

// The fast partial rounds on a group (partial_rounds' schedule).  lm is the
// lane's column of the (WIDTH - 1)-wide tables (lane l >= 1 reads column
// l - 1; lanes 0 and 12-15 read a column whose value they discard).
__device__ __forceinline__ uint64_t partial_rounds_lanes(uint64_t x, int l,
                                                         int lm,
                                                         const LaneConsts& c) {
  const bool dot_lane = l >= 1 && l < WIDTH;
  x = gl::add(x, c.first_rc[l < WIDTH ? l : 0]);
  {
    // mds_partial_layer_init: lane 0 passes, lane c takes
    // sum_r s[r] INIT[r-1][c-1]
    Acc acc;
#pragma unroll
    for (int r = 1; r < WIDTH; r++)
      acc.add_product(from_lane(x, r), c.init[(r - 1) * (WIDTH - 1) + lm]);
    const uint64_t t = acc.reduce();
    if (l != 0) x = t;
  }
#pragma unroll 1
  for (int r = 0; r < PARTIAL; r++) {
    // lane 0's S-box beside the other lanes' W_HATS products
    const uint64_t s0 = gl::add(sbox(x), PARTIAL_RC[r]);
    uint64_t p = dot_lane ? gl::mul(x, c.w_hats[r * (WIDTH - 1) + lm]) : 0;
#pragma unroll
    for (int m = 1; m < GROUP; m <<= 1) p = gl::add(p, from_lane_xor(p, m));
    const uint64_t b = from_lane(s0, 0);
    // lane 0: s0 MDS[0][0] + sum_i s[i] W_HATS[i-1]; lane i: s[i] + s0 VS[i-1]
    x = gl::mul_add(b, l == 0 ? MDS00 : c.vs[r * (WIDTH - 1) + lm],
                    l == 0 ? p : x);
  }
  return x;
}

__device__ __forceinline__ uint64_t permute_lanes(uint64_t x, int l,
                                                  const LaneConsts& c) {
  const int lc = l < WIDTH ? l : WIDTH - 1;
  const int lm = l >= 1 && l < WIDTH ? l - 1 : 0;
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; r++)
    x = full_round_lanes(x, l, c.full_rc[r * WIDTH + lc]);
  x = partial_rounds_lanes(x, l, lm, c);
#pragma unroll 1
  for (int r = HALF_FULL; r < 2 * HALF_FULL; r++)
    x = full_round_lanes(x, l, c.full_rc[r * WIDTH + lc]);
  return x;
}

// A group of GROUP lanes per leaf.  Every lane of the block runs the same
// number of permutations (the leaves share one length), so the shuffles
// see full warps: a group past the last leaf hashes the last leaf again
// and writes nothing.
template <bool COLS>
__device__ __forceinline__ void sponge_group(const Leaves& L, LaneConsts& c) {
  load_lane_consts(c);
  const int l = threadIdx.x % GROUP;
  const int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / GROUP;
  const bool live = g < L.count;
  const int64_t j = live ? g : L.count - 1;
  const uint64_t* leaf = L.leaf<COLS>(j);
  const int64_t step = L.step<COLS>();
  const bool absorbs = l < RATE;
  uint64_t x = 0;
  uint64_t next = absorbs && l < L.len ? leaf[l * step] : 0;
  for (int64_t start = 0; start < L.len; start += RATE) {
    if (absorbs && start + l < L.len) x = next;
    // the next chunk's load, in flight during this permutation
    const int64_t e = start + RATE + l;
    if (absorbs && e < L.len) next = leaf[e * step];
    x = permute_lanes(x, l, c);
  }
  if (live && l < L.num_outputs) L.out[L.slot(j) * L.num_outputs + l] = x;
}

// Four kernels, so that the profiler tells the entries and group sizes
// apart.
__global__ void __launch_bounds__(THREADS, SPONGE_MIN_BLOCKS)
hash_rows_kernel(Leaves L) { sponge_thread<false>(L); }

__global__ void __launch_bounds__(GROUP_THREADS)
hash_rows_group_kernel(Leaves L) {
  __shared__ LaneConsts c;
  sponge_group<false>(L, c);
}

__global__ void __launch_bounds__(THREADS, SPONGE_MIN_BLOCKS)
hash_cols_kernel(Leaves L) { sponge_thread<true>(L); }

__global__ void __launch_bounds__(GROUP_THREADS)
hash_cols_group_kernel(Leaves L) {
  __shared__ LaneConsts c;
  sponge_group<true>(L, c);
}

template <bool COLS>
int launch_sponge(const Leaves& L, int group, int* launches,
                  cudaStream_t stream) {
  *launches = 0;
  if (L.num_outputs < 0 || L.num_outputs > RATE || L.len < 0 || L.count < 0 ||
      (group != 1 && group != GROUP))
    return (int)cudaErrorInvalidValue;
  if (L.count == 0 || L.num_outputs == 0) return (int)cudaGetLastError();
  if (group == 1) {
    const int64_t blocks = (L.count + THREADS - 1) / THREADS;
    if (COLS)
      hash_cols_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(L);
    else
      hash_rows_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(L);
  } else {
    const int64_t per_block = GROUP_THREADS / GROUP;
    const int64_t blocks = (L.count + per_block - 1) / per_block;
    if (COLS)
      hash_cols_group_kernel<<<(unsigned)blocks, GROUP_THREADS, 0, stream>>>(L);
    else
      hash_rows_group_kernel<<<(unsigned)blocks, GROUP_THREADS, 0, stream>>>(L);
  }
  *launches = 1;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int poseidon_permute(const void* in, void* out, int64_t n,
                                int* launches, void* stream) {
  *launches = 0;
  if (n > 0) {
    const int64_t blocks = (n + THREADS - 1) / THREADS;
    poseidon_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n);
    *launches = 1;
  }
  return (int)cudaGetLastError();
}

extern "C" int poseidon_hash_rows(const void* in, void* out, int64_t rows,
                                  int64_t len, int num_outputs, int group,
                                  int* launches, void* stream) {
  const Leaves L{(const uint64_t*)in, (uint64_t*)out, rows, len, len,
                 num_outputs, -1};
  return launch_sponge<false>(L, group, launches, (cudaStream_t)stream);
}

extern "C" int poseidon_hash_cols(const void* in, void* out, int64_t len,
                                  int64_t n, int64_t stride, int num_outputs,
                                  int leaf_order, int group, int* launches,
                                  void* stream) {
  *launches = 0;
  int log_order = -1;
  if (leaf_order) {
    if (n <= 0 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
    log_order = 63 - __builtin_clzll((unsigned long long)n);
  }
  if (len > 0 && stride < n) return (int)cudaErrorInvalidValue;
  const Leaves L{(const uint64_t*)in, (uint64_t*)out, n, len, stride,
                 num_outputs, log_order};
  return launch_sponge<true>(L, group, launches, (cudaStream_t)stream);
}
