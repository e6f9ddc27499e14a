/* LZF compression codec for PCD binary_compressed IO.
 *
 * Fresh implementation of the LZF wire format (compatible with Marc
 * Lehmann's liblzf, which the reference vendors at third_party/liblzf
 * and uses in io/file_pcd.cu:218,436-454).
 *
 * Exposed as plain C symbols loaded through ctypes; built with the
 * system C compiler by cupoch_tpu_torch/utility/lzf.py.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define HLOG 16
#define HSIZE (1u << HLOG)

static inline uint32_t hash3(const uint8_t *p) {
    /* Fibonacci-multiplicative mix (Knuth) of the next 3 bytes; any
     * 3-byte hash preserves the wire format since matches are
     * verified byte-for-byte before being emitted. */
    uint32_t v = ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
    return (v * 2654435761u) >> (32 - HLOG);
}

/* Compress in_len bytes; returns compressed size or 0 if the output
 * would not fit in out_len (callers then store uncompressed). */
long lzf_compress(const uint8_t *in_data, long in_len, uint8_t *out_data,
                  long out_len) {
    static const long MAX_OFF = 1 << 13;
    static const long MAX_LEN = (1 << 8) + (1 << 3);
    const uint8_t *htab[HSIZE];
    const uint8_t *ip = in_data;
    uint8_t *op = out_data;
    const uint8_t *in_end = ip + in_len;
    uint8_t *out_end = op + out_len;
    long lit = 0;
    uint8_t *lit_op;

    if (in_len == 0 || out_len < 2) return 0;
    memset((void *)htab, 0, sizeof(htab));
    lit_op = op++; /* reserved literal-run header */

    while (ip + 2 < in_end) {
        uint32_t hslot = hash3(ip);
        const uint8_t *ref = htab[hslot];
        htab[hslot] = ip;
        long off = ip - ref - 1;

        if (ref && off < MAX_OFF && ref[0] == ip[0] && ref[1] == ip[1] &&
            ref[2] == ip[2]) {
            long maxlen = in_end - ip;
            long len = 3;
            if (maxlen > MAX_LEN) maxlen = MAX_LEN;
            while (len < maxlen && ref[len] == ip[len]) len++;

            if (lit) {
                *lit_op = (uint8_t)(lit - 1);
                lit = 0;
            } else {
                op--; /* reserved header unused */
            }

            long l = len - 2;
            if (op + 4 > out_end) return 0;
            if (l < 7) {
                *op++ = (uint8_t)((off >> 8) + (l << 5));
            } else {
                *op++ = (uint8_t)((off >> 8) + (7 << 5));
                *op++ = (uint8_t)(l - 7);
            }
            *op++ = (uint8_t)off;
            lit_op = op++;

            /* index a couple of positions inside the match */
            if (ip + len + 2 < in_end) {
                htab[hash3(ip + 1)] = ip + 1;
                if (len > 2) htab[hash3(ip + 2)] = ip + 2;
            }
            ip += len;
        } else {
            if (op >= out_end) return 0;
            lit++;
            *op++ = *ip++;
            if (lit == (1 << 5)) {
                *lit_op = (uint8_t)(lit - 1);
                lit = 0;
                lit_op = op++;
            }
        }
    }
    while (ip < in_end) {
        if (op >= out_end) return 0;
        lit++;
        *op++ = *ip++;
        if (lit == (1 << 5)) {
            *lit_op = (uint8_t)(lit - 1);
            lit = 0;
            lit_op = op++;
        }
    }
    if (lit) {
        *lit_op = (uint8_t)(lit - 1);
    } else {
        op--;
    }
    return (long)(op - out_data);
}

/* Decompress; returns decompressed size or 0 on malformed input /
 * overflow. */
long lzf_decompress(const uint8_t *in_data, long in_len, uint8_t *out_data,
                    long out_len) {
    const uint8_t *ip = in_data;
    uint8_t *op = out_data;
    const uint8_t *in_end = ip + in_len;
    uint8_t *out_end = op + out_len;

    while (ip < in_end) {
        uint32_t ctrl = *ip++;
        if (ctrl < (1 << 5)) { /* literal run */
            ctrl++;
            if (op + ctrl > out_end || ip + ctrl > in_end) return 0;
            memcpy(op, ip, ctrl);
            op += ctrl;
            ip += ctrl;
        } else { /* back reference */
            uint32_t len = ctrl >> 5;
            uint8_t *ref;
            if (len == 7) {
                if (ip >= in_end) return 0;
                len += *ip++;
            }
            if (ip >= in_end) return 0;
            ref = op - (((ctrl & 0x1f) << 8) + *ip++) - 1;
            if (ref < out_data || op + len + 2 > out_end) return 0;
            len += 2;
            while (len--) *op++ = *ref++;
        }
    }
    return (long)(op - out_data);
}
