// The host side of check.cuh that the kernel sources share, and its C
// interface: arm a tool, read the reports.  Compiled in only where
// GAT_CHECKED is defined (the library of sanitize.py's builtin checker);
// in the library the port loads this source is empty.

#include "check.cuh"

#ifdef GAT_CHECKED

#include <string>

int gat_check_armed = 0;

namespace {
std::string g_reports;
unsigned long long g_errors = 0;
unsigned long long g_launches = 0;
}  // namespace

void gat_check_record(const std::string& text, unsigned long long errors) {
  g_reports += text;
  g_errors += errors;
  ++g_launches;
}

// Arms `tools` (gat_check::Tool bits; 0 disarms) for the launches that
// follow; returns the tools armed before.
extern "C" int gat_check_arm(int tools) {
  const int before = gat_check_armed;
  gat_check_armed = tools;
  return before;
}

// Errors and checked launches since the last gat_check_clear.
extern "C" unsigned long long gat_check_errors() { return g_errors; }
extern "C" unsigned long long gat_check_launches() { return g_launches; }

// The reports since the last gat_check_clear, a line each.
extern "C" const char* gat_check_reports() { return g_reports.c_str(); }

extern "C" void gat_check_clear() {
  g_reports.clear();
  g_errors = 0;
  g_launches = 0;
}

#endif  // GAT_CHECKED
