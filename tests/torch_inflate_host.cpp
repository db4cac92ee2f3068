// The routines of codec_tcc_tpu_torch/csrc/inflate.cu built by a host
// compiler and run as its four kernels run them (each block's threads in
// turn, the tables built by one lane): the scan over every bit offset, the
// measure of each candidate, the chain walk and the emit of each block
// with its Adler-32 check. The CPU tests compare what this gives with zlib
// and with the plain version (tests/torch_inflate_plain.py).
//
//   g++ -O2 -std=c++17 -shared -fPIC -I codec_tcc_tpu_torch/csrc
//       -o libinflate_host.so tests/torch_inflate_host.cpp
#include <stdlib.h>
#include <string.h>

#include <vector>

#include "inflate.cu"

extern "C" int inflate_host(const unsigned* words, long long nbytes,
                            unsigned char* px, long long n_px, int itemsize,
                            long long* counts) {
    const long long want = n_px * itemsize;
    std::vector<unsigned long long> buf(
        (inf_layout(nbytes, want, nullptr, nullptr) + 7) / 8, 0);
    InfWs ws;
    inf_layout(nbytes, want, (char*)buf.data(), &ws);
    const InfStream s{words, (nbytes + 3) / 4, (unsigned)(8 * nbytes),
                      (unsigned)nbytes};
    InfHead* head = ws.head;
    unsigned char cl[128];
    for (unsigned p = 16; p < s.nbits; ++p) {
        if (!inf_header<false>(s, p, cl, nullptr, nullptr, nullptr, 0, 1,
                               nullptr)) {
            continue;
        }
        const int c = head->ncand++;
        if (c >= ws.cap) continue;
        ws.cand[c].start = p;
        unsigned slot = (p * 2654435761u) & (unsigned)ws.hmask;
        while (ws.hkey[slot]) slot = (slot + 1) & (unsigned)ws.hmask;
        ws.hkey[slot] = p + 1;
        ws.hval[slot] = c;
    }
    InfWarp* w = new InfWarp;
    InfCta* c = new InfCta;
    std::vector<InfStart> starts(INF_CTA * INF_STARTS);
    std::vector<unsigned char> map(2 * INF_CTA * INF_STARTS);
    std::vector<InfScan> scan(2 * INF_CTA);
    c->starts = starts.data();
    c->map = map.data();
    c->scan = scan.data();
    const int n = head->ncand < ws.cap ? head->ncand : ws.cap;
    for (int i = 0; i < n; ++i) {
        const unsigned p = ws.cand[i].start;
        const unsigned data = inf_cta_tables(s, p, *w, *c);
        InfResult res{p, 0, -1, INF_BAD};
        if (data) {
            res = inf_block<false>(s, *w, *c, data, want, INF_MAX_TOKENS,
                                   nullptr, -1, 0, &ws);
        }
        ws.cand[i].end = res.end;
        ws.cand[i].out_len = res.out_len;
        ws.cand[i].last = res.last;
        ws.cand[i].flags = res.flags;
        ws.cand[i].nwin = data ? c->nwin : -1;
        for (int k = 0; k < INF_WINDOWS; ++k) ws.cand[i].win[k] = c->win[k];
    }
    std::vector<InfSink> sinks(INF_CTA);
    for (InfSink& k : sinks) k = InfSink{InfOut{px, n_px, itemsize}, 0, 0, 0};
    inf_chain(s, ws, want, *w, *c, sinks.data());
    if (head->status == INF_OK) {
        const int n_emit =
            head->nblocks < ws.chain_cap ? head->nblocks : ws.chain_cap;
        for (int b = 0; b < n_emit; ++b) {
            inf_emit(s, ws, ws.blocks[b], *w, *c, sinks.data());
        }
        for (const InfSink& k : sinks) {
            head->s1 += k.s1;
            head->s2 += k.s2;
        }
        if (inf_adler(head->s1, head->s2, head->total) != head->trailer) {
            head->status = INF_ADLER;
        }
    }
    delete w;
    delete c;
    counts[0] = head->ncand;
    counts[1] = head->nblocks;
    counts[2] = head->nserial;
    return head->status;
}

// The kernels' caps on the candidates the measure takes and the chain
// blocks the emit takes (ops/inflate.py limits).
extern "C" void inflate_host_limits(long long nbytes, long long want,
                                    long long* out) {
    out[0] = inf_cap(nbytes);
    out[1] = inf_chain_cap(want);
}
