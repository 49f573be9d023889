// Golden-value harness: the monocular-bootstrap joint pose+idepth LM core —
// CoarseInitializer::setFirst point selection (CoarseInitializer.cpp:818-895)
// and calcResAndGS (the Schur-on-idepth residual/Hessian,
// CoarseInitializer.cpp:450-660) — vs sos_slam_tpu/models/initializer.py
// (set_first / calc_res_gs).
//
// The per-level selected points are printed and consumed verbatim by the
// Python side (the JAX build documents an RNG deviation in the level-0
// selector's random directions, so the POINT SET is an input here, not the
// claim). calcResAndGS is then evaluated at several (T, aff, snapped)
// states per level; E / alpha / acc9 H,b / Schur H,b are the goldens.
#include "util/IndexThreadReduce.h"
#include "util/FrameShell.h"
#include "util/globalCalib.h"
#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <iostream>
#include <limits>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>
#define private public
#define protected public
#include "FullSystem/CoarseInitializer.h"
#include "FullSystem/HessianBlocks.h"
#undef private
#undef protected
#include "util/settings.h"

using namespace dso;

int dso::FrameHessian::instanceCounter = 0;
int dso::CalibHessian::instanceCounter = 0;

static const int W = 256, H = 192;
static const float FX = 200.f, FY = 200.f, CX = 128.f, CY = 96.f;

static float lattice(int a, int b) {
  return (float)(int)(((unsigned)(a * 73856093) ^ (unsigned)(b * 19349663)) %
                      61u);
}
static float tex(int x, int y) {
  int x0 = x >> 3, y0 = y >> 3;
  float fx = (float)(x & 7) * 0.125f, fy = (float)(y & 7) * 0.125f;
  float v00 = lattice(x0, y0), v10 = lattice(x0 + 1, y0);
  float v01 = lattice(x0, y0 + 1), v11 = lattice(x0 + 1, y0 + 1);
  float a = v00 + (v10 - v00) * fx;
  float b = v01 + (v11 - v01) * fx;
  int ramp = (x * 7 + y * 13) % 97;
  if (ramp < 0) ramp += 97;
  return 0.5f * (float)ramp + (a + (b - a) * fy) + 30.0f;
}

static FrameHessian *make_frame(int shift, CalibHessian *hcalib) {
  std::vector<float> img(W * H);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) img[x + y * W] = tex(x + shift, y);
  FrameHessian *fh = new FrameHessian();
  FrameShell *sh = new FrameShell();
  fh->shell = sh;
  fh->ab_exposure = 1.0;
  fh->makeImages(img.data(), hcalib);
  return fh;
}

int main() {
  Eigen::Matrix3f K;
  K << FX, 0.f, CX, 0.f, FY, CY, 0.f, 0.f, 1.f;
  setGlobalCalib(W, H, K);
  setting_enable_scale_opt = false;

  CalibHessian hcalib;
  FrameHessian *first = make_frame(0, &hcalib);
  FrameHessian *second = make_frame(6, &hcalib);

  std::vector<double> tfm_vec(16, 0.0);
  tfm_vec[0] = tfm_vec[5] = tfm_vec[10] = tfm_vec[15] = 1.0;
  CoarseInitializer ci(W, H, tfm_vec, K);
  ci.setFirst(&hcalib, first);
  ci.newFrame = second;

  for (int lvl = 0; lvl < pyrLevelsUsed; lvl++) {
    printf("inpn %d %d\n", lvl, ci.numPoints[lvl]);
    for (int i = 0; i < ci.numPoints[lvl]; i++) {
      Pnt *p = ci.points[lvl] + i;
      printf("inp %d %.9g %.9g %.9g %d\n", lvl, p->u, p->v, p->my_type,
             p->isGood ? 1 : 0);
    }
  }

  // evaluation states: identity-ish and truth-ish (the scene plane at
  // idepth 0.5 with texture shift 6 => t = (-6/FX/0.5 ... but points start
  // at idepth 1, so states here just probe the function, not consistency)
  struct St { double t[3]; double r[3]; double a, b; int snapped; };
  St states[3] = {
      {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, 0.0, 0.0, 0},
      {{-0.03, 0.004, -0.006}, {0.002, -0.0015, 0.001}, 0.05, -1.5, 0},
      {{-0.06, 0.0, 0.0}, {0.0, 0.0, 0.0}, 0.0, 0.0, 1},
  };

  // trackFrame's LM setup (CoarseInitializer.cpp:236-239) — these members
  // are NOT ctor-initialized
  ci.alphaK = 2.5 * 2.5;
  ci.alphaW = 150 * 150;
  ci.couplingWeight = 1;

  for (int si = 0; si < 3; si++) {
    SE3 T(SO3::exp(Vec3(states[si].r[0], states[si].r[1], states[si].r[2])),
          Vec3(states[si].t[0], states[si].t[1], states[si].t[2]));
    AffLight aff(states[si].a, states[si].b);
    ci.snapped = states[si].snapped != 0;
    for (int lvl = 0; lvl < pyrLevelsUsed; lvl++) {
      // trackFrame resets the new-state fields before linearizing
      for (int i = 0; i < ci.numPoints[lvl]; i++) {
        Pnt *p = ci.points[lvl] + i;
        p->idepth_new = p->idepth;
        p->energy.setZero();
        p->isGood_new = p->isGood;
      }
      Mat88f Hf, Hsc;
      Vec8f bf, bsc;
      Vec3f E = ci.calcResAndGS(lvl, Hf, bf, Hsc, bsc, T, aff, false);
      printf("ires %d %d %.17g %.17g %.9g\n", si, lvl, (double)E[0],
             (double)E[1], (double)E[2]);
      printf("iH %d %d", si, lvl);
      for (int a = 0; a < 8; a++)
        for (int b = 0; b < 8; b++) printf(" %.9g", (double)Hf(a, b));
      printf("\n");
      printf("ib %d %d", si, lvl);
      for (int a = 0; a < 8; a++) printf(" %.9g", (double)bf[a]);
      printf("\n");
      printf("iHsc %d %d", si, lvl);
      for (int a = 0; a < 8; a++)
        for (int b = 0; b < 8; b++) printf(" %.9g", (double)Hsc(a, b));
      printf("\n");
      printf("ibsc %d %d", si, lvl);
      for (int a = 0; a < 8; a++) printf(" %.9g", (double)bsc[a]);
      printf("\n");
    }
  }
  return 0;
}
