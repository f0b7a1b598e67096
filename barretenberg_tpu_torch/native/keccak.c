/* Keccak-f[1600] permutation + Keccak-256 sponge (original padding 0x01,
 * matching Ethereum's keccak256 and the reference's vendored hasher,
 * reference: keccak/keccakf1600.c, keccak.c).
 *
 * Built as a shared object at import time (the native sub-package) and
 * driven through ctypes; the Fiat-Shamir transcript is inherently
 * sequential host work, so it lives in C, not on device.
 */

#include <stdint.h>
#include <string.h>

#define ROL64(x, s) (((x) << (s)) | ((x) >> (64 - (s))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static const int RHO[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                            27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};

static const int PI[24] = {10, 7,  11, 17, 18, 3,  5,  16, 8,  21, 24, 4,
                           15, 23, 19, 13, 12, 2,  20, 14, 22, 9,  6,  1};

void keccakf1600(uint64_t st[25]) {
    uint64_t bc[5], t;
    for (int round = 0; round < 24; ++round) {
        /* theta */
        for (int i = 0; i < 5; ++i)
            bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; ++i) {
            t = bc[(i + 4) % 5] ^ ROL64(bc[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5)
                st[j + i] ^= t;
        }
        /* rho + pi */
        t = st[1];
        for (int i = 0; i < 24; ++i) {
            int j = PI[i];
            bc[0] = st[j];
            st[j] = ROL64(t, RHO[i]);
            t = bc[0];
        }
        /* chi */
        for (int j = 0; j < 25; j += 5) {
            for (int i = 0; i < 5; ++i)
                bc[i] = st[j + i];
            for (int i = 0; i < 5; ++i)
                st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
        }
        /* iota */
        st[0] ^= RC[round];
    }
}

/* Keccak-256: rate 136 bytes, original 0x01 padding. out: 32 bytes. */
void keccak256(const uint8_t *data, uint64_t len, uint8_t *out) {
    uint64_t st[25];
    uint8_t block[136];
    memset(st, 0, sizeof(st));
    while (len >= 136) {
        for (int i = 0; i < 17; ++i) {
            uint64_t w;
            memcpy(&w, data + 8 * i, 8);
            st[i] ^= w;
        }
        keccakf1600(st);
        data += 136;
        len -= 136;
    }
    memset(block, 0, sizeof(block));
    memcpy(block, data, len);
    block[len] = 0x01;
    block[135] |= 0x80;
    for (int i = 0; i < 17; ++i) {
        uint64_t w;
        memcpy(&w, block + 8 * i, 8);
        st[i] ^= w;
    }
    keccakf1600(st);
    memcpy(out, st, 32);
}
