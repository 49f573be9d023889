// Golden-value harness: the reference BA core —
// PointFrameResidual::linearize (Residuals.cpp:77-271), the stitched
// top/Schur Hessians (AccumulatedTopHessian.cpp:35-301,
// AccumulatedSCHessian.cpp:32-79) and the vision-only solve path
// (EnergyFunctional::solveSystemF, EnergyFunctional.cpp:1029-1184) — vs
// sos_slam_tpu/ops/ba.py (linearize / accumulate_top / accumulate_schur /
// solve_system / resubstitute).
//
// A 3-frame window over the shared deterministic integer texture (shifted
// copies ⇒ consistent fronto-parallel scene at ID ≈ 0.5 plus a tiny rotation
// to keep every Jacobian path generic), ~60 points hosted in all three
// frames, residuals in every direction, nonzero FEJ deltas on pose, affine
// and idepth. Prints every RawResidualJacobian, the stitched H/b (active +
// Schur), the solve step x, and per-point idepth steps.
// expose the accumulate/solve internals and the tracker/scale-optimizer
// buffers for golden readout (the selector harness uses the same trick for
// PixelSelector2.h); all std/Eigen/boost headers must be fully included
// BEFORE the access hack
#include "util/IndexThreadReduce.h"
#include "util/FrameShell.h"
#include "util/globalCalib.h"
#include "IOWrapper/Output3DWrapper.h"
#include <Eigen/Geometry>
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
#include "OptimizationBackend/EnergyFunctional.h"
#include "FullSystem/FullSystem.h"
#undef private
#undef protected
#include "FullSystem/ImmaturePoint.h"
#include "FullSystem/Residuals.h"
#include "OptimizationBackend/EnergyFunctionalStructs.h"
#include "util/FrameShell.h"
#include "util/globalCalib.h"
#include "util/settings.h"
#include <cmath>
#include <cstdio>
#include <vector>

using namespace dso;

int dso::FrameHessian::instanceCounter = 0;
int dso::CalibHessian::instanceCounter = 0;
int dso::PointHessian::instanceCounter = 0;

static const int W = 256, H = 192;
static const float FX = 200.f, FY = 200.f, CX = 128.f, CY = 96.f;
static const float ID_TRUE = 0.5f;

// smooth value-noise texture: every operation is exact in f32 (integer
// lattice values < 61, dyadic 1/8-step interpolation weights), so numpy
// reproduces it bitwise
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

// frame-i texture shift: the scene plane at idepth ID_TRUE seen from a
// camera at camToWorld translation x = D/(FX*ID_TRUE)
static const int DS[3] = {0, 4, 7};
static const double EXPOSURES[3] = {1.0, 1.1, 0.9};

static FrameHessian *make_frame(int i, CalibHessian *hcalib) {
  // image = irradiance × exposure (so the exposure part of the affine
  // transfer is physically consistent); ×e_i is one exact f32 multiply
  std::vector<float> img(W * H);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++)
      img[x + y * W] = tex(x + DS[i], y) * (float)EXPOSURES[i];
  FrameHessian *fh = new FrameHessian();
  FrameShell *sh = new FrameShell();
  sh->id = i;
  sh->incoming_id = i;
  sh->timestamp = 0.1 * i;
  fh->shell = sh;
  fh->ab_exposure = EXPOSURES[i];
  fh->makeImages(img.data(), hcalib);
  fh->frameID = i;
  fh->idx = i;

  // eval-point pose: translation matching the texture shift + a tiny
  // rotation so rotational Jacobian terms are exercised
  double tx = (double)DS[i] / (FX * ID_TRUE);
  Vec3 rot(0.0008 * i, -0.0005 * i, 0.0011 * i);
  SE3 camToWorld(SO3::exp(rot), Vec3(tx, 0.001 * i, -0.002 * i));
  fh->setEvalPT_scaled(camToWorld, AffLight(0, 0));

  // FEJ delta: internal-unit state offset (pose + affine), small enough
  // to keep sub-pixel misalignment on the smooth texture
  Vec10 st = Vec10::Zero();
  for (int k = 0; k < 3; k++)
    st[k] = 0.004 * std::sin(1.0 + 3.0 * i + 0.7 * k);
  for (int k = 3; k < 6; k++)
    st[k] = 0.0012 * std::sin(1.0 + 3.0 * i + 0.7 * k);
  st[6] = 0.002 * (i + 1);
  st[7] = -0.0015 * (i - 1);
  fh->setState(st);
  fh->frameEnergyTH = 12 * 12 * patternNum;

  // print the exact pose/state inputs so the Python side consumes them
  // verbatim (no cross-language sin/SE3-exp reproduction needed)
  const Eigen::Matrix<double, 4, 4> T = camToWorld.matrix();
  printf("frame %d %.17g %.17g", i, fh->ab_exposure, fh->frameEnergyTH);
  for (int a = 0; a < 4; a++)
    for (int b = 0; b < 4; b++) printf(" %.17g", T(a, b));
  for (int k = 0; k < 10; k++) printf(" %.17g", st[k]);
  printf("\n");
  return fh;
}

int main() {
  Eigen::Matrix3f K;
  K << FX, 0.f, CX, 0.f, FY, CY, 0.f, 0.f, 1.f;
  setGlobalCalib(W, H, K);
  setting_enable_imu = false;
  setting_enable_scale_opt = false;
  multiThreading = false;  // serial accumulation: deterministic sum order

  CalibHessian hcalib;

  EnergyFunctional ef;
  ef.red = new IndexThreadReduce<Vec10>();

  std::vector<FrameHessian *> frames;
  for (int i = 0; i < 3; i++) {
    FrameHessian *fh = make_frame(i, &hcalib);
    frames.push_back(fh);
    ef.insertFrame(fh, &hcalib);
  }

  // points hosted in every frame; residuals toward both other frames
  std::vector<PointHessian *> points;
  std::vector<PointFrameResidual *> residuals;
  for (int hi = 0; hi < 3; hi++) {
    int n = 0;
    for (int v = 30; v <= H - 30 && n < 20; v += 24)
      for (int u = 30; u <= W - 30 && n < 20; u += 24, n++) {
        ImmaturePoint imm(u, v, frames[hi], 1.0f, &hcalib);
        float id0 = 0.5f + 0.02f * (float)((u + v) % 5);
        if (n % 7 == 3) id0 += 0.35f;  // wrong depth → outlier path
        imm.idepth_min = id0;
        imm.idepth_max = id0;
        PointHessian *ph = new PointHessian(&imm, &hcalib);
        ph->setIdepthZero(id0);
        ph->setIdepth(id0 + 0.01f);  // nonzero idepth FEJ delta
        ph->setPointStatus(PointHessian::ACTIVE);
        points.push_back(ph);
        ef.insertPoint(ph);
        printf("pt %d %d %d %.9g %.9g %.9g\n", hi, u, v, ph->idepth,
               ph->idepth_zero, ph->energyTH);
        for (int ti = 0; ti < 3; ti++) {
          if (ti == hi) continue;
          PointFrameResidual *r =
              new PointFrameResidual(ph, frames[hi], frames[ti]);
          ph->residuals.push_back(r);
          ef.insertResidual(r);
          residuals.push_back(r);
        }
      }
  }

  ef.setAdjointsF(&hcalib);
  ef.makeIDX();

  // FullSystem::setPrecalcValues (FullSystem.cpp:1099-1107)
  for (FrameHessian *fh : frames) {
    fh->targetPrecalc.resize(frames.size());
    for (size_t i = 0; i < frames.size(); i++)
      fh->targetPrecalc[i].set(fh, frames[i], &hcalib);
  }
  ef.setDeltaF(&hcalib);

  // linearize all + print every RawResidualJacobian
  for (size_t k = 0; k < residuals.size(); k++) {
    PointFrameResidual *r = residuals[k];
    double e = r->linearize(&hcalib);
    printf("lin %zu %d %d %.9g %.9g %d", k, r->host->idx, r->target->idx, e,
           r->state_NewEnergyWithOutlier, (int)r->state_NewState);
    RawResidualJacobian *J = r->J;
    for (int i = 0; i < patternNum; i++) printf(" %.9g", J->resF[i]);
    for (int c = 0; c < 2; c++)
      for (int i = 0; i < 6; i++) printf(" %.9g", J->Jpdxi[c][i]);
    for (int c = 0; c < 2; c++)
      for (int i = 0; i < 4; i++) printf(" %.9g", J->Jpdc[c][i]);
    printf(" %.9g %.9g", J->Jpdd[0], J->Jpdd[1]);
    for (int c = 0; c < 2; c++)
      for (int i = 0; i < patternNum; i++) printf(" %.9g", J->JIdx[c][i]);
    for (int c = 0; c < 2; c++)
      for (int i = 0; i < patternNum; i++) printf(" %.9g", J->JabF[c][i]);
    for (int a = 0; a < 2; a++)
      for (int b = 0; b < 2; b++) printf(" %.9g", J->JIdx2(a, b));
    for (int a = 0; a < 2; a++)
      for (int b = 0; b < 2; b++) printf(" %.9g", J->JabJIdx(a, b));
    printf(" %.9g %.9g %.9g\n", r->centerProjectedTo[0],
           r->centerProjectedTo[1], r->centerProjectedTo[2]);
    r->applyRes(true);
  }

  // stitched active + linearized(prior-carrying) + Schur systems
  // (solveSystemF internals, vision path; HFinal_top = HL + HA)
  MatXX HA, HL, HSC;
  VecX bA, bL, bSC;
  ef.accumulateAF_MT(HA, bA, false);
  ef.accumulateLF_MT(HL, bL, false);
  ef.accumulateSCF_MT(HSC, bSC, false);
  HA += HL;
  bA += bL;
  int dim = (int)bA.size();
  printf("dim %d\n", dim);
  for (int i = 0; i < dim; i++)
    for (int j = 0; j < dim; j++)
      printf("HA %d %d %.17g\n", i, j, HA(i, j));
  for (int i = 0; i < dim; i++) printf("bA %d %.17g\n", i, bA(i));
  for (int i = 0; i < dim; i++)
    for (int j = 0; j < dim; j++)
      printf("HSC %d %d %.17g\n", i, j, HSC(i, j));
  for (int i = 0; i < dim; i++) printf("bSC %d %.17g\n", i, bSC(i));

  // full solve + resubstitution
  ef.solveSystemF(0, 1e-5, &hcalib);
  for (int i = 0; i < (int)ef.lastX.size(); i++)
    printf("x %d %.17g\n", i, ef.lastX(i));
  for (size_t k = 0; k < points.size(); k++)
    printf("pstep %zu %.9g\n", k, points[k]->step);

  // ================= CoarseTracker golden =================
  // template from the window (makeCoarseDepthL0, CoarseTracker.cpp:56-230)
  // + full coarse-to-fine track of a 4th frame
  // (trackNewestCoarse, :366-552).
  // right-camera baseline for the scale section: disparity D_R at ID_TRUE
  const int D_R = 5;
  const double BASE = (double)D_R / (FX * ID_TRUE);
  std::vector<double> tfm_vec(16, 0.0);   // cam0 -> cam1 (right): x -= BASE
  tfm_vec[0] = tfm_vec[5] = tfm_vec[10] = tfm_vec[15] = 1.0;
  tfm_vec[3] = -BASE;
  setting_enable_scale_opt = true;

  // wire lastResiduals[0] to each point's residual toward frame 2
  for (PointFrameResidual *r : residuals) {
    if (r->target == frames[2] && r->state_state == ResState::IN)
      r->point->lastResiduals[0] = std::make_pair(r, ResState::IN);
  }
  for (PointHessian *ph : points)
    ph->host->pointHessians.push_back(ph);

  CoarseTracker ct(W, H, tfm_vec, K);
  ct.makeK(&hcalib);
  ct.setCoarseTrackingRef(frames);

  for (int lvl = 0; lvl < pyrLevelsUsed; lvl++) {
    printf("pcn %d %d\n", lvl, ct.pc_n[lvl]);
    for (int i = 0; i < ct.pc_n[lvl]; i++)
      printf("pc %d %.9g %.9g %.9g %.9g\n", lvl, ct.pc_u[lvl][i],
             ct.pc_v[lvl][i], ct.pc_idepth[lvl][i], ct.pc_color[lvl][i]);
  }

  // 4th frame: texture shift D3 => plane-consistent pose, small affine
  {
    const int D3 = 9;
    std::vector<float> img(W * H);
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++)
        img[x + y * W] = tex(x + D3, y) * 1.05f;
    FrameHessian *fh = new FrameHessian();
    FrameShell *sh = new FrameShell();
    sh->id = 3;
    fh->shell = sh;
    fh->ab_exposure = 1.05;
    fh->makeImages(img.data(), &hcalib);

    // initial guess: last-to-new from the true relative translation,
    // perturbed (the tracker must pull it back)
    double tx3 = (double)D3 / (FX * ID_TRUE);
    SE3 T3(SO3::exp(Vec3(0.0015, -0.001, 0.002)),
           Vec3(tx3, 0.002, -0.003));
    SE3 lastToNew = SE3(T3.matrix()).inverse() *
                    frames[2]->get_camToWorld_evalPT();
    // perturb the init
    lastToNew = SE3::exp((Vec6() << 0.01, -0.008, 0.012, 0.002, -0.001,
                          0.0015).finished()) * lastToNew;
    const Eigen::Matrix<double, 4, 4> Tinit = lastToNew.matrix();
    printf("track_init");
    for (int a = 0; a < 4; a++)
      for (int b = 0; b < 4; b++) printf(" %.17g", Tinit(a, b));
    printf("\n");

    AffLight aff_out(0, 0);
    Vec5 minRes = Vec5::Constant(NAN);
    Vec5 lastRes = Vec5::Constant(NAN);
    bool ok = ct.trackNewestCoarse(fh, lastToNew, aff_out,
                                   pyrLevelsUsed - 1, minRes, lastRes);
    const Eigen::Matrix<double, 4, 4> Tout = lastToNew.matrix();
    printf("track_ok %d\n", ok ? 1 : 0);
    printf("track_T");
    for (int a = 0; a < 4; a++)
      for (int b = 0; b < 4; b++) printf(" %.17g", Tout(a, b));
    printf("\n");
    printf("track_aff %.9g %.9g\n", aff_out.a, aff_out.b);
    printf("track_res");
    for (int i = 0; i < 5; i++) printf(" %.9g", lastRes[i]);
    printf("\n");
    printf("track_flow %.9g %.9g %.9g\n", ct.lastFlowIndicators[0],
           ct.lastFlowIndicators[1], ct.lastFlowIndicators[2]);
  }

  // ================= ScaleOptimizer golden =================
  // right frame: the plane seen from a camera at +BASE in x => texture
  // shift D_R; the metric scale of the window is ~1, so optimizeScale
  // must converge close to 1. Init 1.1: at 1.8 the 2+ px disparity error
  // decorrelates the value-noise texture into a saturated plateau and the
  // reference itself stalls in a spurious local minimum.
  {
    std::vector<float> img(W * H);
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) img[x + y * W] = tex(x + D_R, y);
    FrameHessian *fhr = new FrameHessian();
    FrameShell *shr = new FrameShell();
    shr->id = 4;
    fhr->shell = shr;
    fhr->ab_exposure = 1.0;
    fhr->makeImages(img.data(), &hcalib);

    // the window's deliberate idepth perturbations make the full
    // optimizeScale trajectory plateau-chaotic (E(s) is monotone in s), so
    // the golden surface is the residual/Hessian FUNCTION itself:
    // calcResScale + calcGSSSEScale over a scale ladder at every level
    ct.fhStereo = fhr;
    const double SCALES[8] = {0.5, 0.9, 1.0, 1.1, 1.19, 1.4, 2.0, 4.0};
    for (int lvl = 0; lvl < pyrLevelsUsed; lvl++)
      for (int si = 0; si < 8; si++) {
        float sv = (float)SCALES[si];
        Vec6 r = ct.calcResScale(lvl, sv, setting_coarseCutoffTH);
        float Hs, bs;
        ct.calcGSSSEScale(lvl, Hs, bs, sv);
        printf("sres %d %.9g %.17g %.9g %.9g %.17g %.17g\n", lvl, sv, r[0],
               r[1], r[5], (double)Hs, (double)bs);
      }

    float scale = 1.1f;
    float res = ct.optimizeScale(fhr, scale, pyrLevelsUsed - 1);
    printf("scale_opt %.9g %.9g\n", scale, res);
  }

  // ================= marginalization golden =================
  // FullSystem's removal flow (flagPointsForRemoval, FullSystem.cpp:533-585
  // -> marginalizePointsF -> drop residuals targeting the dead frame ->
  // EnergyFunctional::marginalizeFrame). Points hosted in frame 0 are
  // marginalized, then frame 0 is Schur-ed out of HM/bM.
  for (PointHessian *ph : points)
    if (ph->host == frames[0]) {
      ph->efPoint->stateFlag = EFPointStatus::PS_MARGINALIZE;
      for (PointFrameResidual *r : ph->residuals)
        if (r->efResidual && r->efResidual->isActive())
          r->efResidual->fixLinearizationF(&ef);
    }
  ef.marginalizePointsF();
  {
    int dm = (int)ef.bM.size();
    printf("margp_dim %d\n", dm);
    for (int i = 0; i < dm; i++)
      for (int j = 0; j < dm; j++)
        printf("HMp %d %d %.17g\n", i, j, ef.HM(i, j));
    for (int i = 0; i < dm; i++) printf("bMp %d %.17g\n", i, ef.bM(i));
  }
  for (PointFrameResidual *r : residuals)
    if (r->target == frames[0] && r->point->efPoint != 0 &&
        r->efResidual != 0)
      ef.dropResidual(r->efResidual);
  ef.marginalizeFrame(frames[0]->efFrame, &hcalib);
  {
    int dm = (int)ef.bM.size();
    printf("margf_dim %d\n", dm);
    for (int i = 0; i < dm; i++)
      for (int j = 0; j < dm; j++)
        printf("HMm %d %d %.17g\n", i, j, ef.HM(i, j));
    for (int i = 0; i < dm; i++) printf("bMm %d %.17g\n", i, ef.bM(i));
  }

  return 0;
}
