// Native GTF/GFF3 annotation parser.
//
// Ports strawberry_tpu/io/gff.py (itself a quirk-exact mirror of the
// reference's GffReader, src/gff.cpp / include/gff.h) — validated
// structure-for-structure against the Python oracle by
// tests/test_native_gff.py and end-to-end by the golden CLI tests:
//   * chromosome names lowercased (gff.cpp:118)
//   * a non-'.' score column DROPS the line (the early return at
//     gff.cpp:143-148)
//   * feature type classified by substring on the lowercased type column
//   * GffLine::extractAttr semantics: case-insensitive word-boundary match
//     outside double quotes, value to '"'/';', matched span REMOVED from
//     the info string between successive extracts
//   * GFF3 ID-substring reclassification ("transcript"/"gene" in ID)
//   * GTF exon lines auto-create their gene/transcript (gff.cpp:517-556)
//   * a NEW chromosome block on every chrom change, even if seen before
//   * per block: forward transcripts, then reverse, then unstranded
//   * minus-strand descending exon order reversed (gff.cpp:572-582)
//
// Output: flat transcript arrays (block offsets, strand, exon ranges) plus
// '\n'-joined string blobs, consumed by io/gff.py:parse_native.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {
typedef int64_t i64;

enum FeatType {
  FEAT_OTHERS = 0,
  FEAT_UTR,
  FEAT_EXON,
  FEAT_STOP,
  FEAT_START,
  FEAT_CDS,
  FEAT_MRNA,
  FEAT_GENE
};

static const unsigned char* lower_tbl() {
  static unsigned char t[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i)
      t[i] = (unsigned char)std::tolower(i);
    init = true;
  }
  return t;
}

static void lower_into(std::string_view s, std::string& out) {
  const unsigned char* t = lower_tbl();
  out.resize(s.size());
  for (size_t i = 0; i < s.size(); ++i)
    out[i] = (char)t[(unsigned char)s[i]];
}

static bool contains(const std::string& hay, const char* needle) {
  return hay.find(needle) != std::string::npos;
}

// GffLine::extractAttr (gff.cpp:13-79 / io/gff.py:_extract_attr):
// find `attr` (case-insensitive) outside quotes at a word boundary, return
// the value and REMOVE the matched span from info. info_l is the lowered
// twin of info, kept position-synced (spans removed from both) so the
// case-insensitive search needs no fresh lowercase pass per attribute.
static std::string extract_attr(std::string& info, std::string& info_l,
                                const std::string& attr_l) {
  size_t attrlen = attr_l.size();
  char cend = attr_l.back();
  size_t n = info.size();
  size_t pos = 0;
  size_t found = std::string::npos;
  while (true) {
    size_t cand = info_l.find(attr_l, pos);
    if (cand == std::string::npos) break;
    size_t quotes = 0;
    for (size_t q = 0; q < cand; ++q)
      if (info[q] == '"') quotes++;
    if (quotes & 1) {  // inside quotes
      pos = cand + 1;
      continue;
    }
    char prevch = cand > 0 ? info[cand - 1] : '\0';
    if (prevch == '\0' || prevch == ' ' || prevch == ';') {
      size_t epos = cand + attrlen;
      if (cend == '=' || cend == ' ' || epos >= n || info[epos] == ' ') {
        found = cand;
        break;
      }
      pos = epos;
      continue;
    }
    pos = cand + 1;
  }
  if (found == std::string::npos) return "";
  size_t vp = found + attrlen;
  while (vp < n && info[vp] == ' ') vp++;
  bool dq = false;
  if (vp < n && info[vp] == '"') {
    dq = true;
    vp++;
  }
  size_t vend = vp;
  if (dq) {
    while (vend < n && info[vend] != '"' && info[vend] != ';') vend++;
  } else {
    while (vend < n && info[vend] != ';') vend++;
  }
  std::string val = info.substr(vp, vend - vp);
  while (vend < n &&
         (info[vend] == '"' || info[vend] == ';' || info[vend] == ' '))
    vend++;
  info.erase(found, vend - found);
  info_l.erase(found, vend - found);
  return val;
}

// t.lstrip("-").isdigit() then int(t) — nonpositive/garbage -> 0
static i64 parse_coord(std::string_view s) {
  size_t i = 0;
  while (i < s.size() && s[i] == '-') i++;
  if (i == s.size()) return 0;
  for (size_t k = i; k < s.size(); ++k)
    if (!std::isdigit((unsigned char)s[k])) return 0;
  // int("--5") would raise in the oracle; only a single '-' is a number
  if (i > 1) return 0;
  i64 v = 0;
  bool neg = i == 1;
  for (size_t k = i; k < s.size(); ++k) v = v * 10 + (s[k] - '0');
  return neg ? -v : v;
}

struct Tx {
  std::string trans_id, gene_id, gene_name;
  int8_t strand;
  std::vector<i64> exl, exr;
};

struct Gene {
  std::string gene_id, gene_name;
};

struct Block {
  std::string name;
  std::vector<Gene> genes;
  std::unordered_map<std::string, size_t> gene_by_id;
  std::vector<Tx> fwd, rev, uns;
  std::unordered_map<std::string, std::pair<std::vector<Tx>*, size_t>>
      rna_by_key;  // key = tid + '\x01' + strand

  Gene* find_gene(const std::string& gid) {
    auto it = gene_by_id.find(gid);
    return it == gene_by_id.end() ? nullptr : &genes[it->second];
  }
  void add_gene(Gene g) {
    gene_by_id[g.gene_id] = genes.size();
    genes.push_back(std::move(g));
  }
  static void rna_key(const std::string& tid, int8_t strand,
                      std::string& kbuf) {
    kbuf.assign(tid);
    kbuf.push_back('\x01');
    kbuf.push_back((char)('0' + strand));
  }
  Tx* find_rna(const std::string& tid, int8_t strand, std::string& kbuf) {
    rna_key(tid, strand, kbuf);
    auto it = rna_by_key.find(kbuf);
    if (it == rna_by_key.end()) return nullptr;
    return &(*it->second.first)[it->second.second];
  }
  Tx* add_rna(Tx t, std::string& kbuf) {
    std::vector<Tx>* lst = t.strand == 1 ? &fwd : t.strand == 2 ? &rev : &uns;
    rna_key(t.trans_id, t.strand, kbuf);
    lst->push_back(std::move(t));
    rna_by_key[kbuf] = {lst, lst->size() - 1};
    return &lst->back();
  }
};

}  // namespace

extern "C" {

struct StrawbGff {
  std::vector<Block> blocks;
  // flattened output
  std::string chroms_blob, tids_blob, gids_blob, gnames_blob;
  std::vector<i64> block_tx_off;  // nblocks+1
  std::vector<int8_t> tx_strand;
  std::vector<i64> tx_exon_off;  // ntx+1
  std::vector<i64> ex_l, ex_r;
  i64 ntx = 0;
  int ok = 0;
};

StrawbGff* strawb_gff_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  auto* G = new StrawbGff();
  if (!f) return G;
  std::string raw;
  {
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    raw.resize(sz);
    if (sz && fread(&raw[0], 1, sz, f) != (size_t)sz) {
      fclose(f);
      return G;
    }
    fclose(f);
  }

  Block* cur = nullptr;
  std::string prev_chrom = "\x01\x01";  // sentinel: no chrom yet
  std::vector<std::string_view> t;
  // per-line scratch buffers, hoisted (allocation-free steady state)
  std::string chrom, ft, info, info_l, kbuf;
  size_t lp = 0;
  while (lp <= raw.size()) {
    size_t le = raw.find('\n', lp);
    if (le == std::string::npos) le = raw.size();
    std::string_view line(raw.data() + lp, le - lp);
    lp = le + 1;
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.remove_suffix(1);
    // skip: blank/comment/short (io/gff.py:144-147)
    size_t s0 = line.find_first_not_of(" \t\r\n\v\f");
    if (s0 == std::string_view::npos || line[s0] == '#' ||
        line.size() < 10) {
      if (lp > raw.size()) break;
      continue;
    }
    t.clear();
    {
      size_t p = 0;
      while (true) {
        size_t q = line.find('\t', p);
        if (q == std::string_view::npos) {
          t.push_back(line.substr(p));
          break;
        }
        t.push_back(line.substr(p, q - p));
        p = q + 1;
      }
    }
    if (t.size() < 9) continue;
    lower_into(t[0], chrom);
    i64 start = parse_coord(t[3]);
    i64 end = parse_coord(t[4]);
    if (start == 0 || end == 0) continue;
    if (end < start) std::swap(start, end);
    if (t[5] != ".") continue;  // numeric-score drop quirk
    int8_t strand = t[6] == "+" ? 1 : t[6] == "-" ? 2 : 0;
    lower_into(t[2], ft);
    int feat_type;
    if (contains(ft, "utr")) feat_type = FEAT_UTR;
    else if (contains(ft, "exon")) feat_type = FEAT_EXON;
    else if (contains(ft, "stop") &&
             (contains(ft, "codon") || contains(ft, "cds")))
      feat_type = FEAT_STOP;
    else if (contains(ft, "start") &&
             (contains(ft, "codon") || contains(ft, "cds")))
      feat_type = FEAT_START;
    else if (ft == "cds") feat_type = FEAT_CDS;
    else if (contains(ft, "rna") || contains(ft, "transcript"))
      feat_type = FEAT_MRNA;
    else if (contains(ft, "gene")) feat_type = FEAT_GENE;
    else continue;

    static const std::string kId = "id=", kParent = "parent=",
        kName = "name=", kGeneName = "gene_name=", kGenename = "genename=",
        kGeneSym = "gene_sym=", kGeneEq = "gene=", kGeneId = "gene_id",
        kGeneNameA = "gene_name", kTranscriptId = "transcript_id";
    info.assign(t[8]);
    lower_into(t[8], info_l);
    // "id=" / "parent=" need an '=' somewhere; GTF attr strings have
    // none, so one memchr replaces two failing scans per line
    bool has_eq = memchr(info.data(), '=', info.size()) != nullptr;
    std::string ID = has_eq ? extract_attr(info, info_l, kId)
                            : std::string();
    std::string parent = has_eq ? extract_attr(info, info_l, kParent)
                                : std::string();
    bool is_gff3 = !ID.empty() || !parent.empty();
    std::string name, gene_id, gene_name, transcript_id;
    if (is_gff3) {
      if (!ID.empty()) {
        if (contains(ID, "transcript")) feat_type = FEAT_MRNA;
        else if (contains(ID, "gene")) feat_type = FEAT_GENE;
        name = extract_attr(info, info_l, kName);
        if (name.empty()) name = extract_attr(info, info_l, kGeneName);
        if (name.empty()) name = extract_attr(info, info_l, kGenename);
        if (name.empty()) name = extract_attr(info, info_l, kGeneSym);
        if (name.empty()) name = extract_attr(info, info_l, kGeneEq);
      }
      if (!parent.empty()) {
        size_t comma = parent.find(',');
        if (comma != std::string::npos) parent = parent.substr(0, comma);
      }
    } else {
      gene_id = extract_attr(info, info_l, kGeneId);
      gene_name = extract_attr(info, info_l, kGeneNameA);
      transcript_id = extract_attr(info, info_l, kTranscriptId);
      if (feat_type == FEAT_GENE) {
        ID = gene_id;
        name = gene_name;
      } else {
        ID = transcript_id;
      }
    }

    if (chrom != prev_chrom) {
      prev_chrom = chrom;
      G->blocks.emplace_back();
      cur = &G->blocks.back();
      cur->name = chrom;
    }
    if (feat_type == FEAT_GENE) {
      cur->add_gene(Gene{ID, name});
    } else if (feat_type == FEAT_MRNA) {
      Gene* gene = cur->find_gene(parent);
      if (!gene) continue;
      Tx tx;
      tx.trans_id = ID;
      tx.gene_id = gene->gene_id;
      tx.gene_name = gene->gene_name;
      tx.strand = strand;
      cur->add_rna(std::move(tx), kbuf);
    } else if (feat_type == FEAT_EXON) {
      std::string par = !parent.empty() ? parent : transcript_id;
      if (par.empty()) continue;
      Tx* mrna = cur->find_rna(par, strand, kbuf);
      if (!mrna) {
        Gene* gene = cur->find_gene(gene_id);
        if (!gene) {
          // GffLoci(id) sets gene_name = id (gff.h:261)
          cur->add_gene(Gene{gene_id, gene_id});
          gene = cur->find_gene(gene_id);
        }
        Tx tx;
        tx.trans_id = par;
        tx.gene_id = gene->gene_id;
        tx.gene_name = gene->gene_name;
        tx.strand = strand;
        mrna = cur->add_rna(std::move(tx), kbuf);
      }
      mrna->exl.push_back(start);
      mrna->exr.push_back(end);
    }
    if (lp > raw.size()) break;
  }

  // minus-strand exon-order fix (gff.cpp:572-582)
  for (Block& b : G->blocks)
    for (Tx& tx : b.rev)
      if (tx.exl.size() > 1 &&
          std::make_pair(tx.exl[0], tx.exr[0]) >
              std::make_pair(tx.exl[1], tx.exr[1])) {
        std::reverse(tx.exl.begin(), tx.exl.end());
        std::reverse(tx.exr.begin(), tx.exr.end());
      }

  // flatten: per block forward, reverse, unstranded
  G->block_tx_off.push_back(0);
  G->tx_exon_off.push_back(0);
  for (Block& b : G->blocks) {
    G->chroms_blob += b.name;
    G->chroms_blob += '\n';
    for (std::vector<Tx>* lst : {&b.fwd, &b.rev, &b.uns}) {
      for (Tx& tx : *lst) {
        G->tids_blob += tx.trans_id;
        G->tids_blob += '\n';
        G->gids_blob += tx.gene_id;
        G->gids_blob += '\n';
        G->gnames_blob += tx.gene_name;
        G->gnames_blob += '\n';
        G->tx_strand.push_back(tx.strand);
        G->ex_l.insert(G->ex_l.end(), tx.exl.begin(), tx.exl.end());
        G->ex_r.insert(G->ex_r.end(), tx.exr.begin(), tx.exr.end());
        G->tx_exon_off.push_back((i64)G->ex_l.size());
        G->ntx++;
      }
    }
    G->block_tx_off.push_back(G->ntx);
  }
  G->blocks.clear();
  G->ok = 1;
  return G;
}

int strawb_gff_ok(StrawbGff* g) { return g->ok; }
i64 strawb_gff_nblocks(StrawbGff* g) {
  return (i64)g->block_tx_off.size() - 1;
}
i64 strawb_gff_ntx(StrawbGff* g) { return g->ntx; }
i64 strawb_gff_nexons(StrawbGff* g) { return (i64)g->ex_l.size(); }
const char* strawb_gff_chroms(StrawbGff* g) { return g->chroms_blob.c_str(); }
const char* strawb_gff_tids(StrawbGff* g) { return g->tids_blob.c_str(); }
const char* strawb_gff_gids(StrawbGff* g) { return g->gids_blob.c_str(); }
const char* strawb_gff_gnames(StrawbGff* g) { return g->gnames_blob.c_str(); }
const i64* strawb_gff_blocktx(StrawbGff* g) { return g->block_tx_off.data(); }
const int8_t* strawb_gff_strand(StrawbGff* g) { return g->tx_strand.data(); }
const i64* strawb_gff_exoff(StrawbGff* g) { return g->tx_exon_off.data(); }
const i64* strawb_gff_exl(StrawbGff* g) { return g->ex_l.data(); }
const i64* strawb_gff_exr(StrawbGff* g) { return g->ex_r.data(); }
void strawb_gff_free(StrawbGff* g) { delete g; }

}  // extern "C"
