/* The port's native IO library: the host side of a run, in C.
 *
 *   - pst_parse_float_pairs: the cross-section table parser (the
 *     reference's processCSData, src/cross_section.cu:3-28), line by line
 *     with strtod;
 *   - pst_write_png: the snapshot encoder (the reference's image() over
 *     libpng, src/utility.cu:4-74): 8-bit RGB, filter 0 on every row, one
 *     IDAT from zlib's compress2;
 *   - pst_append_lines: appends a block of text (the reference's printCSV,
 *     src/utility.cu:87-106).
 *
 * A plain C interface, built at first use by the host C compiler and
 * loaded with ctypes (utils/fastio.py), which checks every size and type
 * before it passes a pointer.  Each function returns a count or 0, or one
 * of the negative codes below.
 */

#include <errno.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

#define PST_IO_ERROR (-1)   /* errno says why */
#define PST_BAD_LINE (-2)   /* *bad_line holds the line's number, from 1 */
#define PST_NO_MEMORY (-3)
#define PST_ZLIB_ERROR (-4)

/* The whole file, NUL-terminated, or NULL with errno set.  Read in chunks,
   so a pipe or a FIFO reads as a regular file does. */
static char *read_file(const char *path, size_t *size)
{
    FILE *f = fopen(path, "rb");
    if (!f)
        return NULL;
    size_t cap = 1 << 16, len = 0;
    char *buf = (char *)malloc(cap + 1);
    while (buf) {
        len += fread(buf + len, 1, cap - len, f);
        if (len < cap)
            break;
        cap *= 2;
        char *grown = (char *)realloc(buf, cap + 1);
        if (!grown) {
            free(buf);
            buf = NULL;
        } else {
            buf = grown;
        }
    }
    if (!buf) {
        fclose(f);
        errno = ENOMEM;
        return NULL;
    }
    if (ferror(f)) {
        int err = errno;
        free(buf);
        fclose(f);
        errno = err;
        return NULL;
    }
    fclose(f);
    buf[len] = '\0';
    *size = len;
    return buf;
}

static int is_blank(char c)
{
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

/* The first n rows of a table of float pairs into out[2n].  A line's text
   from '#' on is a comment; a line with nothing else is skipped; any other
   line holds exactly two numbers that strtod reads whole, apart by blanks.
   Returns the rows read (n, or fewer at the end of the file). */
long long pst_parse_float_pairs(const char *path, long long n, double *out,
                                long long *bad_line)
{
    size_t size;
    char *buf = read_file(path, &size);
    if (!buf)
        return errno == ENOMEM ? PST_NO_MEMORY : PST_IO_ERROR;
    char *p = buf, *end = buf + size;
    long long rows = 0, line = 0;
    while (rows < n && p < end) {
        char *eol = (char *)memchr(p, '\n', (size_t)(end - p));
        if (!eol)
            eol = end;
        char *stop = (char *)memchr(p, '#', (size_t)(eol - p));
        if (!stop)
            stop = eol;
        *stop = '\0';  /* strtod ends at the line's end */
        line++;
        double v[2];
        int k = 0;
        for (;;) {
            while (p < stop && is_blank(*p))
                p++;
            if (p == stop)
                break;
            char *num_end;
            double x = strtod(p, &num_end);
            if (k == 2 || num_end == p
                || (num_end < stop && !is_blank(*num_end))) {
                free(buf);
                *bad_line = line;
                return PST_BAD_LINE;
            }
            v[k++] = x;
            p = num_end;
        }
        if (k == 1) {
            free(buf);
            *bad_line = line;
            return PST_BAD_LINE;
        }
        if (k == 2) {
            out[2 * rows] = v[0];
            out[2 * rows + 1] = v[1];
            rows++;
        }
        p = eol + 1;
    }
    free(buf);
    return rows;
}

static void put_be32(unsigned char *p, unsigned long v)
{
    p[0] = (unsigned char)(v >> 24);
    p[1] = (unsigned char)(v >> 16);
    p[2] = (unsigned char)(v >> 8);
    p[3] = (unsigned char)v;
}

static int write_chunk(FILE *f, const char *tag, const unsigned char *data,
                       size_t len)
{
    unsigned char head[8], tail[4];
    put_be32(head, (unsigned long)len);
    memcpy(head + 4, tag, 4);
    uLong crc = crc32(0L, (const Bytef *)tag, 4);
    if (len)
        crc = crc32(crc, data, (uInt)len);
    put_be32(tail, crc);
    return fwrite(head, 1, 8, f) == 8
        && (len == 0 || fwrite(data, 1, len, f) == len)
        && fwrite(tail, 1, 4, f) == 4;
}

/* An (h, w, 3) uint8 image, rows contiguous, as a PNG file. */
int pst_write_png(const char *path, const unsigned char *rgb, int w, int h,
                  int level)
{
    size_t stride = (size_t)w * 3;
    size_t raw_len = (size_t)h * (stride + 1);
    unsigned char *raw = (unsigned char *)malloc(raw_len);
    if (!raw)
        return PST_NO_MEMORY;
    for (size_t y = 0; y < (size_t)h; y++) {
        raw[y * (stride + 1)] = 0;  /* filter 0: the row as it is */
        memcpy(raw + y * (stride + 1) + 1, rgb + y * stride, stride);
    }
    uLongf z_len = compressBound((uLong)raw_len);
    unsigned char *z = (unsigned char *)malloc(z_len);
    if (!z) {
        free(raw);
        return PST_NO_MEMORY;
    }
    int zrc = compress2(z, &z_len, raw, (uLong)raw_len, level);
    free(raw);
    if (zrc != Z_OK) {
        free(z);
        return zrc == Z_MEM_ERROR ? PST_NO_MEMORY : PST_ZLIB_ERROR;
    }
    FILE *f = fopen(path, "wb");
    if (!f) {
        free(z);
        return PST_IO_ERROR;
    }
    static const unsigned char sig[8] = {0x89, 'P', 'N', 'G',
                                         '\r', '\n', 0x1a, '\n'};
    unsigned char ihdr[13];
    put_be32(ihdr, (unsigned long)w);
    put_be32(ihdr + 4, (unsigned long)h);
    ihdr[8] = 8;   /* bit depth */
    ihdr[9] = 2;   /* colour type RGB */
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    int ok = fwrite(sig, 1, 8, f) == 8
        && write_chunk(f, "IHDR", ihdr, 13)
        && write_chunk(f, "IDAT", z, z_len)
        && write_chunk(f, "IEND", NULL, 0);
    free(z);
    if (fclose(f) != 0)
        ok = 0;
    return ok ? 0 : PST_IO_ERROR;
}

/* len bytes of text at the end of the file (created if missing). */
int pst_append_lines(const char *path, const char *blob, long long len)
{
    FILE *f = fopen(path, "ab");
    if (!f)
        return PST_IO_ERROR;
    int ok = len == 0 || fwrite(blob, 1, (size_t)len, f) == (size_t)len;
    if (fclose(f) != 0)
        ok = 0;
    return ok ? 0 : PST_IO_ERROR;
}

/* The zlib the library runs with: its PNG bytes equal Python's
   zlib.compress where the two versions are equal. */
const char *pst_zlib_version(void)
{
    return zlibVersion();
}
