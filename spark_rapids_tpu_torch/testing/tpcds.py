"""TPC-DS tables for the port: a copy of the JAX package's generator
(``spark_rapids_tpu/testing/tpcds.py``: ``_BASE``, ``_money`` and
``generate_tables`` ``:82``), kept here because the port imports nothing of
the JAX package and ``chip_smoke.py`` needs the tables on a machine
without it.  It is host numpy; the same ``sf`` and ``seed`` give the same
arrays as the JAX package's generator, column by column (a test checks).

Row counts scale with ``sf`` from ``_BASE`` (store_sales 30,000 rows per
sf); date_dim and the other small dimensions do not scale.  Money columns
are doubles rounded to cents, as in the JAX package.

``Q3_COLUMNS``, ``Q1_COLUMNS``, ``Q7_COLUMNS``, ``Q15_COLUMNS``,
``Q12_COLUMNS``, ``Q20_COLUMNS``, ``Q13_COLUMNS``, ``Q19_COLUMNS`` and
``Q16_COLUMNS`` name the columns each query reads; ``q3_tables`` to
``q16_tables`` cut the generator's dict down to them (the port has no
column pruning), sharing its arrays.  ``q3``, ``q1``, ``q7``, ``q15``,
``q12`` (q20 is ``q12(..., prefix="cs")``), ``q13``, ``q19`` and ``q16``
are the queries of ``spark_rapids_tpu/testing/tpcds_queries.py`` as
DataFrame recipes (the port has no SQL front end), and ``q3_numpy`` to
``q16_numpy`` the same queries in numpy."""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np


_BASE = {
    "store_sales": 30_000,
    "store_returns": 3_000,
    "catalog_sales": 15_000,
    "catalog_returns": 1_500,
    "web_sales": 8_000,
    "web_returns": 800,
    "customer": 2_000,
    "customer_address": 1_000,
    "customer_demographics": 1_920,
    "household_demographics": 720,
    "item": 2_000,
    "store": 12,
    "promotion": 30,
    "reason": 35,
    "web_site": 6,
    "catalog_page": 120,
    "call_center": 6,
    "date_dim": 1_461,   # 4 years: 1998-2002
    "warehouse": 5,
    "inventory": 20_000,
}

_STATES = np.array(["TN", "GA", "AL", "SC", "NC", "KY", "VA", "FL", "MS",
                    "TX"])
_COUNTIES = np.array([
    "Rush County", "Toole County", "Jefferson County", "Dona Ana County",
    "La Porte County", "Ziebach County", "Fairfield County", "Walker County",
    "Daviess County", "Barrow County"])
_CATEGORIES = np.array(["Sports", "Books", "Home", "Electronics", "Jewelry",
                        "Men", "Women", "Music", "Children", "Shoes"])
_EDU = np.array(["Primary", "Secondary", "College", "2 yr Degree",
                 "4 yr Degree", "Advanced Degree", "Unknown"])
_DAYS = np.array(["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                  "Friday", "Saturday"])

# zip pool overlapping the literal IN-lists the queries carry (q8 names 120
# specific 5-digit zips and then requires >2 preferred customers per zip —
# uniform 5-digit zips make its result empty at every realistic SF); half
# the pool comes from q8's list, half is filler, all reused heavily so the
# HAVING count(*) > 2 clause can fire
_ZIP_POOL = np.array([
    "24128", "76232", "65084", "87816", "83926", "77556", "20548", "26231",
    "43848", "15126", "91137", "61265", "98294", "25782", "17920", "18426",
    "98235", "40081", "84093", "28577", "55565", "17183", "54601", "67897",
    "30411", "12345", "55901", "77001", "94105", "60601", "30301", "73301",
    "85001", "19101", "48201", "63101", "37201", "40201", "23220", "29201"])


def _money(rng, n, lo=0.5, hi=300.0):
    return np.round(rng.uniform(lo, hi, n), 2)


def generate_tables(sf: float = 0.01, seed: int = 20) -> Dict[str, dict]:
    """Returns {table_name: column dict} ready for create_dataframe."""
    rng = np.random.default_rng(seed)
    n = {t: max(4, int(b * sf)) if t not in
         ("date_dim", "store", "reason", "web_site", "promotion",
          "catalog_page", "customer_demographics",
          "household_demographics", "warehouse") else b
         for t, b in _BASE.items()}
    t: Dict[str, dict] = {}

    # ---- date_dim: 1998-01-01 .. 2001-12-31, sk = julian-ish index -------
    nd = n["date_dim"]
    base = np.datetime64("1998-01-01")
    dates = base + np.arange(nd)
    dsk = 2_450_815 + np.arange(nd, dtype=np.int64)
    years = dates.astype("datetime64[Y]").astype(int) + 1970
    months = dates.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (dates - dates.astype("datetime64[M]")).astype(int) + 1
    doy = (dates - dates.astype("datetime64[Y]")).astype(int)
    t["date_dim"] = {
        "d_date_sk": dsk,
        "d_date_id": np.array([f"AAAAAAAA{i:08d}" for i in range(nd)],
                              dtype=object),
        "d_date": dates.astype("datetime64[D]"),
        "d_year": years.astype(np.int32),
        "d_moy": months.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": ((months - 1) // 3 + 1).astype(np.int32),
        "d_week_seq": (5270 + (np.arange(nd) + 3) // 7).astype(np.int32),
        "d_month_seq": ((years - 1900) * 12 + months - 1).astype(np.int32),
        "d_day_name": _DAYS[(np.arange(nd) + 4) % 7].astype(object),
        "d_quarter_name": np.array(
            [f"{y}Q{(m - 1) // 3 + 1}" for y, m in zip(years, months)],
            dtype=object),
    }

    # ---- small dimensions -------------------------------------------------
    ns = n["store"]
    t["store"] = {
        "s_store_sk": np.arange(1, ns + 1, dtype=np.int64),
        "s_store_id": np.array([f"AAAAAAAA{i:04d}BAAA" for i in range(ns)],
                               dtype=object),
        "s_store_name": np.array(["ought", "able", "pri", "ese", "anti",
                                  "cally", "ation", "eing", "n st", "bar",
                                  "ought2", "able2"][:ns], dtype=object),
        "s_state": rng.choice(_STATES[:4], ns).astype(object),
        # store zips from the same pool as customer addresses so q8's
        # substr(s_zip,1,2) = substr(ca_zip,1,2) prefix join has matches
        "s_zip": rng.choice(_ZIP_POOL, ns).astype(object),
        "s_gmt_offset": np.full(ns, -5.0),
        "s_market_id": (np.arange(ns) % 10 + 1).astype(np.int32),
        "s_county": rng.choice(_COUNTIES[:5], ns).astype(object),
        "s_city": rng.choice(np.array(["Midway", "Fairview", "Oak Grove",
                                       "Glendale", "Centerville"]),
                             ns).astype(object),
        "s_number_employees": rng.integers(200, 301, ns).astype(np.int32),
    }
    nwh = n["warehouse"]
    t["warehouse"] = {
        "w_warehouse_sk": np.arange(1, nwh + 1, dtype=np.int64),
        "w_warehouse_name": np.array(
            [f"Warehouse number {i}" for i in range(1, nwh + 1)],
            dtype=object),
        "w_warehouse_sq_ft": rng.integers(50_000, 1_000_001, nwh).astype(
            np.int32),
        "w_city": rng.choice(np.array(["Midway", "Fairview", "Oak Grove"]),
                             nwh).astype(object),
        "w_county": rng.choice(_COUNTIES[:5], nwh).astype(object),
        "w_state": rng.choice(_STATES[:4], nwh).astype(object),
        "w_country": np.full(nwh, "United States", dtype=object),
    }
    nw = n["web_site"]
    t["web_site"] = {
        "web_site_sk": np.arange(1, nw + 1, dtype=np.int64),
        "web_site_id": np.array([f"site_{i}" for i in range(nw)],
                                dtype=object),
    }
    ncp = n["catalog_page"]
    t["catalog_page"] = {
        "cp_catalog_page_sk": np.arange(1, ncp + 1, dtype=np.int64),
        "cp_catalog_page_id": np.array([f"cpage_{i}" for i in range(ncp)],
                                       dtype=object),
    }
    ncc = n["call_center"]
    t["call_center"] = {
        "cc_call_center_sk": np.arange(1, ncc + 1, dtype=np.int64),
        "cc_call_center_id": np.array([f"cc_{i}" for i in range(ncc)],
                                      dtype=object),
        "cc_county": rng.choice(_COUNTIES[:5], ncc).astype(object),
        "cc_name": np.array([f"center {i}" for i in range(ncc)],
                            dtype=object),
        "cc_manager": np.array([f"Mgr{i}" for i in range(ncc)],
                               dtype=object),
    }
    nr = n["reason"]
    t["reason"] = {
        "r_reason_sk": np.arange(1, nr + 1, dtype=np.int64),
        "r_reason_desc": np.array([f"reason {i}" for i in range(nr)],
                                  dtype=object),
    }
    npm = n["promotion"]
    t["promotion"] = {
        "p_promo_sk": np.arange(1, npm + 1, dtype=np.int64),
        "p_channel_email": rng.choice(np.array(["N", "Y"]), npm,
                                      p=[0.9, 0.1]).astype(object),
        "p_channel_event": rng.choice(np.array(["N", "Y"]), npm,
                                      p=[0.9, 0.1]).astype(object),
        "p_channel_dmail": rng.choice(np.array(["N", "Y"]),
                                      npm).astype(object),
        "p_channel_tv": rng.choice(np.array(["N", "Y"]), npm).astype(object),
    }

    # ---- demographics -----------------------------------------------------
    ncd = n["customer_demographics"]
    genders = np.array(["M", "F"])
    marital = np.array(["M", "S", "D", "W", "U"])
    t["customer_demographics"] = {
        "cd_demo_sk": np.arange(1, ncd + 1, dtype=np.int64),
        "cd_gender": genders[np.arange(ncd) % 2].astype(object),
        "cd_marital_status": marital[(np.arange(ncd) // 2) % 5].astype(object),
        "cd_education_status": _EDU[(np.arange(ncd) // 10) % 7].astype(object),
        "cd_purchase_estimate": (500 * (1 + np.arange(ncd) % 20)).astype(
            np.int32),
        "cd_credit_rating": np.array(["Low Risk", "Good", "High Risk",
                                      "Unknown"])[
            (np.arange(ncd) // 70) % 4].astype(object),
        "cd_dep_count": (np.arange(ncd) % 7).astype(np.int32),
        "cd_dep_employed_count": (np.arange(ncd) % 7).astype(np.int32),
        "cd_dep_college_count": (np.arange(ncd) % 7).astype(np.int32),
    }
    nhd = n["household_demographics"]
    t["household_demographics"] = {
        "hd_demo_sk": np.arange(1, nhd + 1, dtype=np.int64),
        "hd_dep_count": (np.arange(nhd) % 10).astype(np.int32),
        "hd_buy_potential": np.array([">10000", "5001-10000", "1001-5000",
                                      "501-1000", "0-500", "Unknown"])[
            np.arange(nhd) % 6].astype(object),
        "hd_vehicle_count": (np.arange(nhd) % 5).astype(np.int32),
    }

    # ---- customer + address ----------------------------------------------
    nca = n["customer_address"]
    t["customer_address"] = {
        "ca_address_sk": np.arange(1, nca + 1, dtype=np.int64),
        "ca_state": rng.choice(_STATES, nca).astype(object),
        "ca_zip": rng.choice(_ZIP_POOL, nca).astype(object),
        "ca_county": rng.choice(_COUNTIES, nca).astype(object),
        "ca_country": np.full(nca, "United States", dtype=object),
        "ca_gmt_offset": rng.choice(np.array([-5.0, -6.0, -7.0]), nca),
        "ca_city": rng.choice(np.array(["Midway", "Fairview", "Oak Grove",
                                        "Glendale", "Centerville",
                                        "Pleasant Hill", "Springdale"]),
                              nca).astype(object),
    }
    nc = n["customer"]
    t["customer"] = {
        "c_customer_sk": np.arange(1, nc + 1, dtype=np.int64),
        "c_customer_id": np.array([f"AAAAAAAA{i:08d}" for i in range(nc)],
                                  dtype=object),
        "c_current_addr_sk": rng.integers(1, nca + 1, nc),
        "c_current_cdemo_sk": rng.integers(1, ncd + 1, nc),
        "c_current_hdemo_sk": rng.integers(1, nhd + 1, nc),
        "c_first_name": np.array([f"Name{i % 97}" for i in range(nc)],
                                 dtype=object),
        "c_last_name": np.array([f"Last{i % 89}" for i in range(nc)],
                                dtype=object),
        "c_preferred_cust_flag": rng.choice(np.array(["Y", "N"]),
                                            nc).astype(object),
        "c_birth_country": np.full(nc, "UNITED STATES", dtype=object),
        "c_birth_month": rng.integers(1, 13, nc).astype(np.int32),
        "c_birth_year": rng.integers(1930, 1995, nc).astype(np.int32),
        "c_birth_day": rng.integers(1, 29, nc).astype(np.int32),
        "c_email_address": np.array([f"c{i}@example.com"
                                     for i in range(nc)], dtype=object),
        "c_salutation": rng.choice(np.array(["Mr.", "Mrs.", "Ms.", "Dr.",
                                             "Sir"]), nc).astype(object),
        "c_login": np.array([f"login{i}" for i in range(nc)], dtype=object),
        "c_last_review_date_sk": rng.choice(dsk, nc),
    }

    # ---- item --------------------------------------------------------------
    ni = n["item"]
    t["item"] = {
        "i_item_sk": np.arange(1, ni + 1, dtype=np.int64),
        "i_item_id": np.array([f"AAAAAAAA{i:08d}" for i in range(ni)],
                              dtype=object),
        "i_item_desc": np.array([f"desc of item {i}" for i in range(ni)],
                                dtype=object),
        "i_current_price": _money(rng, ni, 0.5, 100.0),
        "i_category": rng.choice(_CATEGORIES, ni).astype(object),
        "i_class": np.array([f"class{i % 16}" for i in range(ni)],
                            dtype=object),
        "i_brand": np.array([f"brand{i % 50}" for i in range(ni)],
                            dtype=object),
        "i_brand_id": (1_000_000 + rng.integers(1, 1000, ni)).astype(
            np.int64),
        # deterministic cycle so the constants queries name (q3:
        # i_manufact_id = 128) are guaranteed present once ni >= 250 and
        # carry ~ni/250 items each — uniform random leaves them absent at
        # small scale and the differential oracle goes vacuous (0 == 0)
        "i_manufact_id": (np.arange(ni) % 250 + 1).astype(np.int64),
        "i_manufact": np.array([f"manufact{i % 250}" for i in range(ni)],
                               dtype=object),
        "i_category_id": rng.integers(1, 11, ni),
        "i_manager_id": rng.integers(1, 100, ni),
        # q24/q41 name specific colors; cycle a pool that includes them
        "i_color": np.array(["pale", "chiffon", "orchid", "powder", "peach",
                             "saddle", "sienna", "spring", "snow", "metallic",
                             "smoke", "almond", "khaki", "dim", "frosted",
                             "forest", "lime", "ghost", "navajo", "slate"])[
            np.arange(ni) % 20].astype(object),
        "i_units": np.array(["Ounce", "Oz", "Bunch", "Ton", "N/A", "Dozen",
                             "Box", "Pound", "Pallet", "Gross", "Cup",
                             "Dram", "Each", "Tbl", "Lb", "Bundle"])[
            np.arange(ni) % 16].astype(object),
        "i_size": np.array(["petite", "small", "medium", "large",
                            "extra large", "economy", "N/A"])[
            np.arange(ni) % 7].astype(object),
        "i_product_name": np.array([f"product{i}" for i in range(ni)],
                                   dtype=object),
        "i_wholesale_cost": _money(rng, ni, 0.5, 80.0),
    }
    nin = n["inventory"]
    # weekly snapshots: every 7th date, items cycling, warehouses cycling
    inv_dates = dsk[::7]
    t["inventory"] = {
        "inv_date_sk": inv_dates[np.arange(nin) % len(inv_dates)],
        "inv_item_sk": (np.arange(nin) % ni + 1).astype(np.int64),
        "inv_warehouse_sk": (np.arange(nin) % nwh + 1).astype(np.int64),
        "inv_quantity_on_hand": rng.integers(0, 1001, nin).astype(np.int32),
    }

    # ---- facts -------------------------------------------------------------
    def fact(prefix, count, cust_col, extra=None):
        m = {
            f"{prefix}_sold_date_sk": rng.choice(dsk, count),
            f"{prefix}_item_sk": rng.integers(1, ni + 1, count),
            f"{cust_col}": rng.integers(1, nc + 1, count),
            f"{prefix}_quantity": rng.integers(1, 101, count).astype(
                np.int32),
            f"{prefix}_list_price": _money(rng, count, 1, 300),
            f"{prefix}_sales_price": _money(rng, count, 1, 300),
            f"{prefix}_ext_sales_price": _money(rng, count, 1, 30_000),
            f"{prefix}_ext_discount_amt": _money(rng, count, 0, 1_000),
            f"{prefix}_ext_wholesale_cost": _money(rng, count, 1, 10_000),
            f"{prefix}_ext_list_price": _money(rng, count, 1, 30_000),
            f"{prefix}_coupon_amt": _money(rng, count, 0, 500),
            f"{prefix}_net_profit": np.round(
                rng.uniform(-5_000, 15_000, count), 2),
            f"{prefix}_net_paid": _money(rng, count, 1, 20_000),
            f"{prefix}_wholesale_cost": _money(rng, count, 1, 100),
            f"{prefix}_ext_ship_cost": _money(rng, count, 1, 1_000),
        }
        if extra:
            m.update(extra)
        return m

    nss = n["store_sales"]
    t["store_sales"] = fact("ss", nss, "ss_customer_sk", {
        "ss_cdemo_sk": rng.integers(1, ncd + 1, nss),
        "ss_hdemo_sk": rng.integers(1, nhd + 1, nss),
        "ss_addr_sk": rng.integers(1, nca + 1, nss),
        "ss_store_sk": rng.integers(1, ns + 1, nss),
        "ss_promo_sk": rng.integers(1, npm + 1, nss),
        "ss_ticket_number": (np.arange(nss) // 2 + 1).astype(np.int64),
    })
    nsr = n["store_returns"]
    # returns reference REAL sales lines (item/customer/ticket copied from
    # a sampled store_sales row) so the q17-style sale->return join is
    # non-vacuous; the return date lands after the sale
    sr_src = rng.integers(0, nss, nsr)
    _sale_dates = t["store_sales"]["ss_sold_date_sk"][sr_src]
    t["store_returns"] = {
        # return 1-90 days AFTER the referenced sale (clipped to the
        # calendar) so date-ordered return-window queries stay sound
        "sr_returned_date_sk": np.minimum(
            _sale_dates + rng.integers(1, 91, nsr), dsk[-1]),
        "sr_item_sk": t["store_sales"]["ss_item_sk"][sr_src],
        "sr_customer_sk": t["store_sales"]["ss_customer_sk"][sr_src],
        "sr_ticket_number": t["store_sales"]["ss_ticket_number"][sr_src],
        "sr_store_sk": rng.integers(1, ns + 1, nsr),
        "sr_return_amt": _money(rng, nsr, 1, 5_000),
        "sr_net_loss": _money(rng, nsr, 1, 2_000),
        "sr_return_quantity": rng.integers(1, 50, nsr).astype(np.int32),
    }
    ncs = n["catalog_sales"]
    t["catalog_sales"] = fact("cs", ncs, "cs_bill_customer_sk", {
        "cs_ship_customer_sk": rng.integers(1, nc + 1, ncs),
        "cs_bill_cdemo_sk": rng.integers(1, ncd + 1, ncs),
        "cs_call_center_sk": rng.integers(1, ncc + 1, ncs),
        "cs_catalog_page_sk": rng.integers(1, ncp + 1, ncs),
        # ~3 lines per order, several warehouses: q16's "ships from >1
        # warehouse" EXISTS needs same-order rows with differing sk
        "cs_order_number": (np.arange(ncs) // 3 + 1).astype(np.int64),
        "cs_warehouse_sk": rng.integers(1, nwh + 1, ncs),
        "cs_ship_date_sk": rng.choice(dsk, ncs),
        "cs_ship_addr_sk": rng.integers(1, nca + 1, ncs),
        "cs_promo_sk": rng.integers(1, npm + 1, ncs),
    })
    ncr = n["catalog_returns"]
    # returns reference REAL catalog sale lines (order + item copied from a
    # sampled row) so the q40-style cs->cr outer join is non-vacuous
    cr_src = rng.integers(0, ncs, ncr)
    t["catalog_returns"] = {
        "cr_returned_date_sk": rng.choice(dsk, ncr),
        "cr_catalog_page_sk": rng.integers(1, ncp + 1, ncr),
        "cr_order_number": t["catalog_sales"]["cs_order_number"][cr_src],
        "cr_item_sk": t["catalog_sales"]["cs_item_sk"][cr_src],
        "cr_return_amount": _money(rng, ncr, 1, 5_000),
        "cr_refunded_cash": _money(rng, ncr, 1, 3_000),
        "cr_net_loss": _money(rng, ncr, 1, 2_000),
        "cr_returning_customer_sk": rng.integers(1, nc + 1, ncr),
    }
    nws = n["web_sales"]
    t["web_sales"] = fact("ws", nws, "ws_bill_customer_sk", {
        "ws_web_site_sk": rng.integers(1, nw + 1, nws),
        "ws_web_page_sk": rng.integers(1, 61, nws),
    })
    nwr = n["web_returns"]
    t["web_returns"] = {
        "wr_returned_date_sk": rng.choice(dsk, nwr),
        "wr_web_page_sk": rng.integers(1, 61, nwr),
        "wr_return_amt": _money(rng, nwr, 1, 5_000),
        "wr_net_loss": _money(rng, nwr, 1, 2_000),
        "wr_returning_customer_sk": rng.integers(1, nc + 1, nwr),
        "wr_returning_addr_sk": rng.integers(1, nca + 1, nwr),
        "wr_item_sk": rng.integers(1, ni + 1, nwr),
        "wr_order_number": (np.arange(nwr) + 1).astype(np.int64),
    }
    return t


#: the columns of each table that TPC-DS q3 reads
Q3_COLUMNS = {
    "date_dim": ["d_date_sk", "d_year", "d_moy"],
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
    "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id"],
}


def q3_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q3 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q3_COLUMNS.items()}


def q3(date_dim, store_sales, item, manufact_id=128, month=11, limit=100):
    """TPC-DS q3 through the port's DataFrame API, over DataFrames of the
    ``Q3_COLUMNS`` of each table.  Returns ``(result, parts)``: ``parts``
    names the intermediate DataFrames (``dt``, ``ss``, ``it``, ``j1``,
    ``j2``, ``agg``, ``sorted``), so a caller can run each step alone.
    ``manufact_id=None`` drops the item filter and ``limit=None`` the
    limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo
    dt = date_dim.filter(EqualTo(col("d_moy"), lit(month)))
    ss = store_sales.select(Alias(col("ss_sold_date_sk"), "d_date_sk"),
                            col("ss_item_sk"), col("ss_ext_sales_price"))
    it = item if manufact_id is None else \
        item.filter(EqualTo(col("i_manufact_id"), lit(manufact_id)))
    it = it.select(Alias(col("i_item_sk"), "ss_item_sk"), col("i_brand_id"),
                   col("i_brand"))
    j1 = dt.join(ss, on="d_date_sk")
    j2 = j1.join(it, on="ss_item_sk")
    agg = (j2.group_by("d_year", "i_brand_id", "i_brand")
           .agg(F.sum("ss_ext_sales_price").alias("sum_agg"))
           .select(col("d_year"), Alias(col("i_brand_id"), "brand_id"),
                   Alias(col("i_brand"), "brand"), col("sum_agg")))
    ordered = agg.order_by("d_year", F.desc("sum_agg"), "brand_id")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"dt": dt, "ss": ss, "it": it, "j1": j1, "j2": j2,
                 "agg": agg, "sorted": ordered}


def q3_numpy(tables: Dict[str, dict], manufact_id=128, month=11,
             limit=100) -> list:
    """TPC-DS q3 in numpy over ``q3_tables`` output: the rows as dicts."""
    d, s, i = tables["date_dim"], tables["store_sales"], tables["item"]
    dmask = d["d_moy"] == month
    year_of = dict(zip(d["d_date_sk"][dmask].tolist(),
                       d["d_year"][dmask].tolist()))
    imask = np.ones(len(i["i_item_sk"]), bool) if manufact_id is None \
        else i["i_manufact_id"] == manufact_id
    item_of = dict(zip(i["i_item_sk"][imask].tolist(),
                       zip(i["i_brand_id"][imask].tolist(),
                           i["i_brand"][imask].tolist())))
    sel = np.isin(s["ss_sold_date_sk"], np.fromiter(year_of, np.int64)) & \
        np.isin(s["ss_item_sk"], np.fromiter(item_of, np.int64))
    sums: Dict[tuple, float] = {}
    for dk, ik, v in zip(s["ss_sold_date_sk"][sel].tolist(),
                         s["ss_item_sk"][sel].tolist(),
                         s["ss_ext_sales_price"][sel].tolist()):
        key = (year_of[dk],) + item_of[ik]
        sums[key] = sums.get(key, 0.0) + v
    rows = sorted(sums.items(), key=lambda kv: (kv[0][0], -kv[1], kv[0][1]))
    if limit is not None:
        rows = rows[:limit]
    return [{"d_year": k[0], "brand_id": k[1], "brand": k[2], "sum_agg": v}
            for k, v in rows]


#: the columns of each table that TPC-DS q1 reads
Q1_COLUMNS = {
    "date_dim": ["d_date_sk", "d_year"],
    "store_returns": ["sr_returned_date_sk", "sr_customer_sk",
                      "sr_store_sk", "sr_return_amt"],
    "store": ["s_store_sk", "s_state"],
    "customer": ["c_customer_sk", "c_customer_id"],
}

#: the columns of each table that TPC-DS q7 reads
Q7_COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk",
                    "ss_promo_sk", "ss_quantity", "ss_list_price",
                    "ss_coupon_amt", "ss_sales_price"],
    "customer_demographics": ["cd_demo_sk", "cd_gender",
                              "cd_marital_status", "cd_education_status"],
    "date_dim": ["d_date_sk", "d_year"],
    "item": ["i_item_sk", "i_item_id"],
    "promotion": ["p_promo_sk", "p_channel_email", "p_channel_event"],
}


def q1_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q1 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q1_COLUMNS.items()}


def q7_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q7 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q7_COLUMNS.items()}


def cte(df):
    """``df`` as a common table expression: a plan that several branches
    of one query read runs once per action (``TorchCteCacheExec``), as
    the JAX package's analyzer wraps a ``WITH`` name used twice."""
    from spark_rapids_tpu_torch.plan import base as L
    from spark_rapids_tpu_torch.session import DataFrame
    return DataFrame(L.CteCache([df._plan]), df._session)


def q1(date_dim, store_returns, store, customer, year=2000, state="TN",
       limit=100):
    """TPC-DS q1 through the port's DataFrame API, over DataFrames of the
    ``Q1_COLUMNS`` of each table, in the JAX plan's join order: the
    ``customer_total_return`` CTE (store_returns joined with the year's
    dates, summed by customer and store) joined with the state's stores,
    then with customer, then, left outer, with the decorrelated scalar
    subquery (the CTE's average by store times 1.2); the rows above it
    keep their customer ids, ordered.  Returns ``(result, parts)``, the
    intermediate DataFrames named in ``parts`` (``ctr``, ``avg``,
    ``joined``, ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import Multiply
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (EqualTo,
                                                               GreaterThan)
    dt = date_dim.filter(EqualTo(col("d_year"), lit(year))) \
        .select(Alias(col("d_date_sk"), "sr_returned_date_sk"))
    sr = store_returns.select(col("sr_returned_date_sk"),
                              Alias(col("sr_customer_sk"), "ctr_customer_sk"),
                              Alias(col("sr_store_sk"), "ctr_store_sk"),
                              col("sr_return_amt"))
    ctr = cte(sr.join(dt, on="sr_returned_date_sk")
              .group_by("ctr_customer_sk", "ctr_store_sk")
              .agg(F.sum("sr_return_amt").alias("ctr_total_return")))
    st = store.filter(EqualTo(col("s_state"), lit(state))) \
        .select(Alias(col("s_store_sk"), "ctr_store_sk"))
    cu = customer.select(Alias(col("c_customer_sk"), "ctr_customer_sk"),
                         col("c_customer_id"))
    avg = (ctr.group_by("ctr_store_sk")
           .agg(F.avg("ctr_total_return").alias("avg_return"))
           .select(col("ctr_store_sk"),
                   Alias(Multiply(col("avg_return"), lit(1.2)), "_sval")))
    joined = (ctr.join(st, on="ctr_store_sk")
              .join(cu, on="ctr_customer_sk")
              .join(avg, on="ctr_store_sk", how="left_outer"))
    ordered = (joined.filter(GreaterThan(col("ctr_total_return"),
                                         col("_sval")))
               .select(col("c_customer_id"))
               .order_by("c_customer_id"))
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"ctr": ctr, "avg": avg, "joined": joined,
                 "sorted": ordered}


def q1_numpy(tables: Dict[str, dict], year=2000, state="TN",
             limit=100) -> list:
    """TPC-DS q1 in numpy over ``q1_tables`` output: the rows as dicts."""
    d, sr = tables["date_dim"], tables["store_returns"]
    s, c = tables["store"], tables["customer"]
    sel = np.isin(sr["sr_returned_date_sk"],
                  d["d_date_sk"][d["d_year"] == year])
    totals: Dict[tuple, float] = {}
    for ck, sk, v in zip(sr["sr_customer_sk"][sel].tolist(),
                         sr["sr_store_sk"][sel].tolist(),
                         sr["sr_return_amt"][sel].tolist()):
        totals[(ck, sk)] = totals.get((ck, sk), 0.0) + v
    by_store: Dict[int, list] = {}
    for (_ck, sk), v in totals.items():
        by_store.setdefault(sk, []).append(v)
    limit_of = {sk: sum(vs) / len(vs) * 1.2 for sk, vs in by_store.items()}
    states = set(s["s_store_sk"][s["s_state"] == state].tolist())
    cid = dict(zip(c["c_customer_sk"].tolist(), c["c_customer_id"]))
    ids = sorted(cid[ck] for (ck, sk), v in totals.items()
                 if sk in states and ck in cid and v > limit_of[sk])
    if limit is not None:
        ids = ids[:limit]
    return [{"c_customer_id": x} for x in ids]


def q7(store_sales, customer_demographics, date_dim, item, promotion,
       year=2000, gender="M", marital="S", education="College", limit=100):
    """TPC-DS q7 through the port's DataFrame API, over DataFrames of the
    ``Q7_COLUMNS`` of each table, in the JAX plan's join order:
    store_sales joined with the filtered customer_demographics, date_dim
    and item, then the promotions reached by email or event; four
    averages by item id, ordered.  Returns ``(result, parts)``
    (``joined``, ``agg``, ``sorted``).  ``limit=None`` drops the
    limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo, Or
    cd = (customer_demographics
          .filter(EqualTo(col("cd_gender"), lit(gender)))
          .filter(EqualTo(col("cd_marital_status"), lit(marital)))
          .filter(EqualTo(col("cd_education_status"), lit(education)))
          .select(Alias(col("cd_demo_sk"), "ss_cdemo_sk")))
    dt = date_dim.filter(EqualTo(col("d_year"), lit(year))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    it = item.select(Alias(col("i_item_sk"), "ss_item_sk"), col("i_item_id"))
    pr = promotion.filter(Or(EqualTo(col("p_channel_email"), lit("N")),
                             EqualTo(col("p_channel_event"), lit("N")))) \
        .select(Alias(col("p_promo_sk"), "ss_promo_sk"))
    joined = (store_sales.join(cd, on="ss_cdemo_sk")
              .join(dt, on="ss_sold_date_sk")
              .join(it, on="ss_item_sk")
              .join(pr, on="ss_promo_sk"))
    agg = joined.group_by("i_item_id").agg(
        F.avg("ss_quantity").alias("agg1"),
        F.avg("ss_list_price").alias("agg2"),
        F.avg("ss_coupon_amt").alias("agg3"),
        F.avg("ss_sales_price").alias("agg4"))
    ordered = agg.order_by("i_item_id")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def q7_numpy(tables: Dict[str, dict], year=2000, gender="M", marital="S",
             education="College", limit=100) -> list:
    """TPC-DS q7 in numpy over ``q7_tables`` output: the rows as dicts."""
    ss, cd = tables["store_sales"], tables["customer_demographics"]
    d, i, p = tables["date_dim"], tables["item"], tables["promotion"]
    cds = cd["cd_demo_sk"][(cd["cd_gender"] == gender) &
                           (cd["cd_marital_status"] == marital) &
                           (cd["cd_education_status"] == education)]
    promos = p["p_promo_sk"][(p["p_channel_email"] == "N") |
                             (p["p_channel_event"] == "N")]
    sel = np.isin(ss["ss_cdemo_sk"], cds) & \
        np.isin(ss["ss_sold_date_sk"], d["d_date_sk"][d["d_year"] == year]) \
        & np.isin(ss["ss_promo_sk"], promos) & \
        np.isin(ss["ss_item_sk"], i["i_item_sk"])
    item_id = dict(zip(i["i_item_sk"].tolist(), i["i_item_id"]))
    cols = ("ss_quantity", "ss_list_price", "ss_coupon_amt",
            "ss_sales_price")
    acc: Dict[str, list] = {}
    for row in zip(ss["ss_item_sk"][sel].tolist(),
                   *(ss[c][sel].tolist() for c in cols)):
        a = acc.setdefault(item_id[row[0]], [0.0, 0.0, 0.0, 0.0, 0])
        for j in range(4):
            a[j] += row[1 + j]
        a[4] += 1
    rows = sorted(acc.items())
    if limit is not None:
        rows = rows[:limit]
    return [{"i_item_id": k, "agg1": a[0] / a[4], "agg2": a[1] / a[4],
             "agg3": a[2] / a[4], "agg4": a[3] / a[4]} for k, a in rows]


#: the columns of each table that TPC-DS q15 reads
Q15_COLUMNS = {
    "catalog_sales": ["cs_sold_date_sk", "cs_bill_customer_sk",
                      "cs_sales_price"],
    "customer": ["c_customer_sk", "c_current_addr_sk"],
    "customer_address": ["ca_address_sk", "ca_state", "ca_zip"],
    "date_dim": ["d_date_sk", "d_year", "d_qoy"],
}

_ITEM_Q12 = ["i_item_sk", "i_item_id", "i_item_desc", "i_category",
             "i_class", "i_current_price"]
#: the columns of each table that TPC-DS q12 (web_sales) and q20
#: (catalog_sales) read
Q12_COLUMNS = {
    "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_ext_sales_price"],
    "item": _ITEM_Q12,
    "date_dim": ["d_date_sk", "d_date"],
}
Q20_COLUMNS = {
    "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_ext_sales_price"],
    "item": _ITEM_Q12,
    "date_dim": ["d_date_sk", "d_date"],
}

Q15_ZIPS = ("85669", "86197", "88274", "83405", "86475", "85392", "85460",
            "80348", "81792")
Q15_STATES = ("CA", "WA", "GA")
Q12_CATEGORIES = ("Sports", "Books", "Home")
Q12_DATES = (datetime.date(1999, 2, 22), datetime.date(1999, 3, 24))


def q15_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q15 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q15_COLUMNS.items()}


def q12_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q12 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q12_COLUMNS.items()}


def q20_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q20 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q20_COLUMNS.items()}


def q15(catalog_sales, customer, customer_address, date_dim, year=2001,
        qoy=2, limit=100):
    """TPC-DS q15 through the port's DataFrame API, over DataFrames of the
    ``Q15_COLUMNS`` of each table, in the JAX plan's join order:
    catalog_sales joined with customer, then customer_address, then the
    quarter's dates; then the filter ``substr(ca_zip, 1, 5) IN (...) OR
    ca_state IN (...) OR cs_sales_price > 500``, the sum by ``ca_zip``,
    ordered.  Returns ``(result, parts)`` (``joined``, ``agg``,
    ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThan, In, Or)
    cs = catalog_sales
    cu = customer.select(Alias(col("c_customer_sk"), "cs_bill_customer_sk"),
                         col("c_current_addr_sk"))
    ca = customer_address.select(Alias(col("ca_address_sk"),
                                       "c_current_addr_sk"),
                                 col("ca_state"), col("ca_zip"))
    dt = date_dim.filter(And(EqualTo(col("d_qoy"), lit(qoy)),
                             EqualTo(col("d_year"), lit(year)))) \
        .select(Alias(col("d_date_sk"), "cs_sold_date_sk"))
    joined = (cs.join(cu, on="cs_bill_customer_sk")
              .join(ca, on="c_current_addr_sk")
              .join(dt, on="cs_sold_date_sk"))
    cond = Or(Or(In(F.substring("ca_zip", 1, 5), Q15_ZIPS),
                 In(col("ca_state"), Q15_STATES)),
              GreaterThan(col("cs_sales_price"), lit(500.0)))
    agg = joined.filter(cond).group_by("ca_zip").agg(
        F.sum("cs_sales_price").alias("total_price"))
    ordered = agg.order_by("ca_zip")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def q15_numpy(tables: Dict[str, dict], year=2001, qoy=2,
              limit=100) -> list:
    """TPC-DS q15 in numpy over ``q15_tables`` output: the rows as dicts."""
    cs, c = tables["catalog_sales"], tables["customer"]
    ca, d = tables["customer_address"], tables["date_dim"]
    dates = d["d_date_sk"][(d["d_qoy"] == qoy) & (d["d_year"] == year)]
    addr_of = dict(zip(c["c_customer_sk"].tolist(),
                       c["c_current_addr_sk"].tolist()))
    place = dict(zip(ca["ca_address_sk"].tolist(),
                     zip(ca["ca_zip"].tolist(), ca["ca_state"].tolist())))
    sel = np.isin(cs["cs_sold_date_sk"], dates)
    sums: Dict[str, float] = {}
    for ck, price in zip(cs["cs_bill_customer_sk"][sel].tolist(),
                         cs["cs_sales_price"][sel].tolist()):
        ak = addr_of.get(ck)
        if ak not in place:
            continue
        z, st = place[ak]
        if z[:5] in Q15_ZIPS or st in Q15_STATES or price > 500:
            sums[z] = sums.get(z, 0.0) + price
    rows = sorted(sums.items())
    if limit is not None:
        rows = rows[:limit]
    return [{"ca_zip": z, "total_price": v} for z, v in rows]


def q12(sales, item, date_dim, prefix="ws", limit=100):
    """TPC-DS q12 (``prefix="ws"``, web_sales) or q20 (``prefix="cs"``,
    catalog_sales) through the port's DataFrame API, over DataFrames of
    the ``Q12_COLUMNS`` or ``Q20_COLUMNS``, in the JAX plan's order: the
    sales joined with the items of three categories, then with the dates
    of 1999-02-22 to 1999-03-24; the revenue summed by five item columns;
    each item's share of its class's revenue, ``itemrevenue * 100.0 /
    sum(itemrevenue) OVER (PARTITION BY i_class)``; ordered by five keys.
    Returns ``(result, parts)`` (``joined``, ``agg``, ``windowed``,
    ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.arithmetic import (Divide,
                                                               Multiply)
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, GreaterThanOrEqual, In, LessThanOrEqual)
    from spark_rapids_tpu_torch.functions import Window
    item_key, date_key = f"{prefix}_item_sk", f"{prefix}_sold_date_sk"
    it = (item.filter(In(col("i_category"), Q12_CATEGORIES))
          .select(Alias(col("i_item_sk"), item_key), *map(col, KEYS_Q12)))
    lo, hi = Q12_DATES
    dt = date_dim.filter(And(GreaterThanOrEqual(col("d_date"), lit(lo)),
                             LessThanOrEqual(col("d_date"), lit(hi)))) \
        .select(Alias(col("d_date_sk"), date_key))
    joined = sales.join(it, on=item_key).join(dt, on=date_key)
    agg = joined.group_by(*KEYS_Q12).agg(
        F.sum(f"{prefix}_ext_sales_price").alias("itemrevenue"))
    share = Divide(Multiply(col("itemrevenue"), lit(100.0)),
                   F.sum("itemrevenue").over(Window.partition_by("i_class")))
    windowed = agg.select(*map(col, KEYS_Q12), col("itemrevenue"),
                          Alias(share, "revenueratio"))
    ordered = windowed.order_by("i_category", "i_class", "i_item_id",
                                "i_item_desc", "revenueratio")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "windowed": windowed,
                 "sorted": ordered}


#: q12's and q20's grouping keys, in the SELECT's order
KEYS_Q12 = ["i_item_id", "i_item_desc", "i_category", "i_class",
            "i_current_price"]


def q12_numpy(tables: Dict[str, dict], prefix="ws", limit=100) -> list:
    """TPC-DS q12 (or q20 with ``prefix="cs"``) in numpy over
    ``q12_tables`` (``q20_tables``) output: the rows as dicts."""
    sales = tables["web_sales" if prefix == "ws" else "catalog_sales"]
    i, d = tables["item"], tables["date_dim"]
    lo, hi = (np.datetime64(x, "D") for x in Q12_DATES)
    dates = d["d_date_sk"][(d["d_date"] >= lo) & (d["d_date"] <= hi)]
    imask = np.isin(i["i_category"], Q12_CATEGORIES)
    item_of = dict(zip(i["i_item_sk"][imask].tolist(),
                       zip(*(i[k][imask].tolist() for k in KEYS_Q12))))
    sel = np.isin(sales[f"{prefix}_sold_date_sk"], dates) & \
        np.isin(sales[f"{prefix}_item_sk"], np.fromiter(item_of, np.int64))
    revenue: Dict[tuple, float] = {}
    for ik, v in zip(sales[f"{prefix}_item_sk"][sel].tolist(),
                     sales[f"{prefix}_ext_sales_price"][sel].tolist()):
        key = item_of[ik]
        revenue[key] = revenue.get(key, 0.0) + v
    by_class: Dict[str, float] = {}
    for key, v in revenue.items():
        by_class[key[3]] = by_class.get(key[3], 0.0) + v
    rows = [dict(zip(KEYS_Q12, key), itemrevenue=v,
                 revenueratio=v * 100.0 / by_class[key[3]])
            for key, v in revenue.items()]
    rows.sort(key=lambda r: (r["i_category"], r["i_class"], r["i_item_id"],
                             r["i_item_desc"], r["revenueratio"]))
    return rows if limit is None else rows[:limit]


def q20_numpy(tables: Dict[str, dict], limit=100) -> list:
    """TPC-DS q20 in numpy over ``q20_tables`` output."""
    return q12_numpy(tables, "cs", limit)


def _lookup(keys: np.ndarray, probe: np.ndarray):
    """``(found, position)``: whether each probe value is among ``keys``
    (unique) and, where it is, its index in ``keys``."""
    order = np.argsort(keys, kind="stable")
    at = np.searchsorted(keys[order], probe)
    at = np.minimum(at, max(len(keys) - 1, 0))
    found = keys[order][at] == probe if len(keys) else \
        np.zeros(len(probe), bool)
    return found, order[at]


#: the columns of each table that TPC-DS q13 reads
Q13_COLUMNS = {
    "store_sales": ["ss_sold_date_sk", "ss_store_sk", "ss_cdemo_sk",
                    "ss_hdemo_sk", "ss_addr_sk", "ss_quantity",
                    "ss_sales_price", "ss_ext_sales_price",
                    "ss_ext_wholesale_cost", "ss_net_profit"],
    "store": ["s_store_sk"],
    "customer_demographics": ["cd_demo_sk", "cd_marital_status",
                              "cd_education_status"],
    "household_demographics": ["hd_demo_sk", "hd_dep_count"],
    "customer_address": ["ca_address_sk", "ca_state", "ca_country"],
    "date_dim": ["d_date_sk", "d_year"],
}
#: q13's three demographic branches: (marital status, education,
#: household dep_count), with ``Q13_PRICES``' ss_sales_price band each
Q13_DEMOGRAPHICS = (("M", "Advanced Degree", 3), ("S", "College", 1),
                    ("W", "2 yr Degree", 1))
Q13_PRICES = ((100.0, 150.0), (50.0, 100.0), (150.0, 200.0))
#: q13's three address branches: states, with ``Q13_PROFITS``'
#: ss_net_profit band each
Q13_STATES = (("TX", "OH", "TN"), ("OR", "NM", "KY"), ("VA", "GA", "MS"))
Q13_PROFITS = ((100.0, 200.0), (150.0, 300.0), (50.0, 250.0))


def q13_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q13 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q13_COLUMNS.items()}


def q13(store_sales, store, customer_demographics, household_demographics,
        customer_address, date_dim, year=2001, prices=Q13_PRICES,
        profits=Q13_PROFITS):
    """TPC-DS q13 through the port's DataFrame API, over DataFrames of the
    ``Q13_COLUMNS`` of each table, in the JAX plan's join order:
    store_sales joined with store, customer_demographics,
    household_demographics, the United States' customer_address and the
    year's date_dim; then one global aggregate (three averages and a sum)
    whose filter, an AND of two ORs of three AND groups, is fused into
    kernel 1, as the JAX package's ``TpuFusedAgg[F]`` does.  ``prices``
    and ``profits`` are the three branches' ss_sales_price and
    ss_net_profit bands (``between``: both ends included).  Returns
    ``(result, parts)`` (``joined``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThanOrEqual, In, LessThanOrEqual, Or)

    def between(name, band):
        return And(GreaterThanOrEqual(col(name), lit(float(band[0]))),
                   LessThanOrEqual(col(name), lit(float(band[1]))))

    def any_of(conds):
        out = conds[0]
        for c in conds[1:]:
            out = Or(out, c)
        return out

    st = store.select(Alias(col("s_store_sk"), "ss_store_sk"))
    cd = customer_demographics.select(
        Alias(col("cd_demo_sk"), "ss_cdemo_sk"), col("cd_marital_status"),
        col("cd_education_status"))
    hd = household_demographics.select(
        Alias(col("hd_demo_sk"), "ss_hdemo_sk"), col("hd_dep_count"))
    ca = customer_address \
        .filter(EqualTo(col("ca_country"), lit("United States"))) \
        .select(Alias(col("ca_address_sk"), "ss_addr_sk"), col("ca_state"))
    dt = date_dim.filter(EqualTo(col("d_year"), lit(year))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    joined = (store_sales.join(st, on="ss_store_sk")
              .join(cd, on="ss_cdemo_sk")
              .join(hd, on="ss_hdemo_sk")
              .join(ca, on="ss_addr_sk")
              .join(dt, on="ss_sold_date_sk"))
    demographic = any_of([
        And(And(And(EqualTo(col("cd_marital_status"), lit(m)),
                    EqualTo(col("cd_education_status"), lit(e))),
                between("ss_sales_price", band)),
            EqualTo(col("hd_dep_count"), lit(dep)))
        for (m, e, dep), band in zip(Q13_DEMOGRAPHICS, prices)])
    address = any_of([And(In(col("ca_state"), states),
                          between("ss_net_profit", band))
                      for states, band in zip(Q13_STATES, profits)])
    out = joined.filter(And(demographic, address)).agg(
        F.avg("ss_quantity").alias("avg1"),
        F.avg("ss_ext_sales_price").alias("avg2"),
        F.avg("ss_ext_wholesale_cost").alias("avg3"),
        F.sum("ss_ext_wholesale_cost").alias("sum1"))
    return out, {"joined": joined}


def q13_numpy(tables: Dict[str, dict], year=2001, prices=Q13_PRICES,
              profits=Q13_PROFITS) -> list:
    """TPC-DS q13 in numpy over ``q13_tables`` output: the one row as a
    dict (its values None when no row passes the filter)."""
    ss, s = tables["store_sales"], tables["store"]
    cd, hd = tables["customer_demographics"], tables["household_demographics"]
    ca, d = tables["customer_address"], tables["date_dim"]
    # each branch's string tests run over the dimension rows, and reach
    # the fact rows through the join's row lookup
    sel = np.isin(ss["ss_store_sk"], s["s_store_sk"]) & \
        np.isin(ss["ss_sold_date_sk"], d["d_date_sk"][d["d_year"] == year])
    found, cd_at = _lookup(cd["cd_demo_sk"], ss["ss_cdemo_sk"])
    sel &= found
    found, hd_at = _lookup(hd["hd_demo_sk"], ss["ss_hdemo_sk"])
    dep = hd["hd_dep_count"][hd_at]
    sel &= found
    us = ca["ca_country"] == "United States"
    found, ca_at = _lookup(ca["ca_address_sk"][us], ss["ss_addr_sk"])
    state = ca["ca_state"][us]
    sel &= found
    price, profit = ss["ss_sales_price"], ss["ss_net_profit"]
    demographic = np.zeros(len(price), bool)
    for (m, e, dp), (lo, hi) in zip(Q13_DEMOGRAPHICS, prices):
        cd_ok = (cd["cd_marital_status"] == m) & \
            (cd["cd_education_status"] == e)
        demographic |= cd_ok[cd_at] & (dep == dp) & (price >= lo) & \
            (price <= hi)
    address = np.zeros(len(price), bool)
    for states, (lo, hi) in zip(Q13_STATES, profits):
        address |= np.isin(state, states)[ca_at] & (profit >= lo) & \
            (profit <= hi)
    sel &= demographic & address
    n = int(sel.sum())

    def avg(c):
        return float(ss[c][sel].astype(np.float64).sum() / n) if n else None
    return [{"avg1": avg("ss_quantity"), "avg2": avg("ss_ext_sales_price"),
             "avg3": avg("ss_ext_wholesale_cost"),
             "sum1": float(ss["ss_ext_wholesale_cost"][sel].sum())
             if n else None}]


#: the columns of each table that TPC-DS q19 reads
Q19_COLUMNS = {
    "date_dim": ["d_date_sk", "d_year", "d_moy"],
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                    "ss_store_sk", "ss_ext_sales_price"],
    "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id",
             "i_manufact", "i_manager_id"],
    "customer": ["c_customer_sk", "c_current_addr_sk"],
    "customer_address": ["ca_address_sk", "ca_zip"],
    "store": ["s_store_sk", "s_zip"],
}


def q19_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q19 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q19_COLUMNS.items()}


def q19(date_dim, store_sales, item, customer, customer_address, store,
        manager_id=8, month=11, year=1998, limit=100):
    """TPC-DS q19 through the port's DataFrame API, over DataFrames of the
    ``Q19_COLUMNS`` of each table, in the JAX plan's join order: the
    month's dates joined with store_sales, then the manager's items,
    customer, customer_address and store, one key each; then the filter
    ``substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)``, the sum by brand id,
    brand, manufacturer id and manufacturer, ordered by the sum
    (descending) and the four keys.  Returns ``(result, parts)``
    (``joined``, ``agg``, ``sorted``).  ``limit=None`` drops the limit."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (And, EqualTo,
                                                               NotEqual)
    dt = date_dim.filter(And(EqualTo(col("d_moy"), lit(month)),
                             EqualTo(col("d_year"), lit(year)))) \
        .select(Alias(col("d_date_sk"), "ss_sold_date_sk"))
    it = item.filter(EqualTo(col("i_manager_id"), lit(manager_id))) \
        .select(Alias(col("i_item_sk"), "ss_item_sk"), col("i_brand_id"),
                col("i_brand"), col("i_manufact_id"), col("i_manufact"))
    cu = customer.select(Alias(col("c_customer_sk"), "ss_customer_sk"),
                         col("c_current_addr_sk"))
    ca = customer_address.select(Alias(col("ca_address_sk"),
                                       "c_current_addr_sk"), col("ca_zip"))
    st = store.select(Alias(col("s_store_sk"), "ss_store_sk"), col("s_zip"))
    joined = (dt.join(store_sales, on="ss_sold_date_sk")
              .join(it, on="ss_item_sk")
              .join(cu, on="ss_customer_sk")
              .join(ca, on="c_current_addr_sk")
              .join(st, on="ss_store_sk"))
    agg = (joined.filter(NotEqual(F.substring("ca_zip", 1, 5),
                                  F.substring("s_zip", 1, 5)))
           .group_by("i_brand_id", "i_brand", "i_manufact_id", "i_manufact")
           .agg(F.sum("ss_ext_sales_price").alias("ext_price"))
           .select(Alias(col("i_brand_id"), "brand_id"),
                   Alias(col("i_brand"), "brand"), col("i_manufact_id"),
                   col("i_manufact"), col("ext_price")))
    ordered = agg.order_by(F.desc("ext_price"), "brand", "brand_id",
                           "i_manufact_id", "i_manufact")
    out = ordered if limit is None else ordered.limit(limit)
    return out, {"joined": joined, "agg": agg, "sorted": ordered}


def q19_numpy(tables: Dict[str, dict], manager_id=8, month=11, year=1998,
              limit=100) -> list:
    """TPC-DS q19 in numpy over ``q19_tables`` output: the rows as dicts."""
    d, ss, i = tables["date_dim"], tables["store_sales"], tables["item"]
    c, ca, s = tables["customer"], tables["customer_address"], tables["store"]
    dates = d["d_date_sk"][(d["d_moy"] == month) & (d["d_year"] == year)]
    sel = np.isin(ss["ss_sold_date_sk"], dates)
    mine = i["i_manager_id"] == manager_id
    found, item_at = _lookup(i["i_item_sk"][mine], ss["ss_item_sk"][sel])
    rows = np.nonzero(sel)[0][found]
    item_at = np.nonzero(mine)[0][item_at[found]]
    found, cust_at = _lookup(c["c_customer_sk"], ss["ss_customer_sk"][rows])
    rows, item_at, cust_at = rows[found], item_at[found], cust_at[found]
    found, addr_at = _lookup(ca["ca_address_sk"],
                             c["c_current_addr_sk"][cust_at])
    rows, item_at, addr_at = rows[found], item_at[found], addr_at[found]
    found, store_at = _lookup(s["s_store_sk"], ss["ss_store_sk"][rows])
    rows, item_at, addr_at, store_at = (rows[found], item_at[found],
                                        addr_at[found], store_at[found])
    sums: Dict[tuple, float] = {}
    for r, ia, aa, sa in zip(rows.tolist(), item_at.tolist(),
                             addr_at.tolist(), store_at.tolist()):
        if ca["ca_zip"][aa][:5] == s["s_zip"][sa][:5]:
            continue
        key = (int(i["i_brand_id"][ia]), i["i_brand"][ia],
               int(i["i_manufact_id"][ia]), i["i_manufact"][ia])
        sums[key] = sums.get(key, 0.0) + float(ss["ss_ext_sales_price"][r])
    out = sorted(sums.items(),
                 key=lambda kv: (-kv[1], kv[0][1], kv[0][0], kv[0][2],
                                 kv[0][3]))
    if limit is not None:
        out = out[:limit]
    return [{"brand_id": k[0], "brand": k[1], "i_manufact_id": k[2],
             "i_manufact": k[3], "ext_price": v} for k, v in out]


#: the columns of each table that TPC-DS q16 reads
Q16_COLUMNS = {
    "catalog_sales": ["cs_ship_date_sk", "cs_ship_addr_sk",
                      "cs_call_center_sk", "cs_order_number",
                      "cs_warehouse_sk", "cs_ext_ship_cost", "cs_net_profit"],
    "date_dim": ["d_date_sk", "d_date"],
    "customer_address": ["ca_address_sk", "ca_state"],
    "call_center": ["cc_call_center_sk", "cc_county"],
    "catalog_returns": ["cr_order_number"],
}
Q16_DATES = (datetime.date(1999, 2, 1), datetime.date(1999, 4, 2))
Q16_COUNTIES = ("Rush County", "Toole County", "Jefferson County",
                "Dona Ana County", "La Porte County")


def q16_tables(tables: Dict[str, dict]) -> Dict[str, dict]:
    """The q16 columns of ``generate_tables``' output."""
    return {t: {c: tables[t][c] for c in cols}
            for t, cols in Q16_COLUMNS.items()}


def q16(catalog_sales, date_dim, customer_address, call_center,
        catalog_returns, state="GA"):
    """TPC-DS q16 through the port's DataFrame API, over DataFrames of the
    ``Q16_COLUMNS`` of each table, in the JAX plan's order: catalog_sales
    joined with the ship dates of 1999-02-01 to 1999-04-02, the state's
    addresses and the five counties' call centers; then a left semi join
    with the orders shipped from more than one warehouse (the ``IN``
    subquery: ``count(DISTINCT cs_warehouse_sk) > 1`` by order), a left
    anti join with the returned orders (``NOT IN``, planned as a plain
    anti join as the JAX analyzer plans it) and one global aggregate:
    ``count(DISTINCT cs_order_number)`` and two sums.  The query's
    ``order by`` and ``limit`` over its one row are left out.  Returns
    ``(result, parts)`` (``joined``, ``multi``, ``kept``)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import (
        And, EqualTo, GreaterThan, GreaterThanOrEqual, In, LessThanOrEqual)
    lo, hi = Q16_DATES
    dt = date_dim.filter(And(GreaterThanOrEqual(col("d_date"), lit(lo)),
                             LessThanOrEqual(col("d_date"), lit(hi)))) \
        .select(Alias(col("d_date_sk"), "cs_ship_date_sk"))
    ca = customer_address.filter(EqualTo(col("ca_state"), lit(state))) \
        .select(Alias(col("ca_address_sk"), "cs_ship_addr_sk"))
    cc = call_center.filter(In(col("cc_county"), Q16_COUNTIES)) \
        .select(Alias(col("cc_call_center_sk"), "cs_call_center_sk"))
    joined = (catalog_sales.join(dt, on="cs_ship_date_sk")
              .join(ca, on="cs_ship_addr_sk")
              .join(cc, on="cs_call_center_sk"))
    multi = (catalog_sales.group_by("cs_order_number")
             .agg(F.count_distinct("cs_warehouse_sk").alias("warehouses"))
             .filter(GreaterThan(col("warehouses"), lit(1)))
             .select(col("cs_order_number")))
    returned = catalog_returns.select(Alias(col("cr_order_number"),
                                            "cs_order_number"))
    kept = joined.join(multi, on="cs_order_number", how="semi") \
        .join(returned, on="cs_order_number", how="anti")
    out = kept.agg(F.count_distinct("cs_order_number").alias("order_count"),
                   F.sum("cs_ext_ship_cost").alias("total_shipping_cost"),
                   F.sum("cs_net_profit").alias("total_net_profit"))
    return out, {"joined": joined, "multi": multi, "kept": kept}


def q16_numpy(tables: Dict[str, dict], state="GA") -> list:
    """TPC-DS q16 in numpy over ``q16_tables`` output: the one row as a
    dict."""
    cs, d = tables["catalog_sales"], tables["date_dim"]
    ca, cc = tables["customer_address"], tables["call_center"]
    lo, hi = (np.datetime64(x, "D") for x in Q16_DATES)
    dates = d["d_date_sk"][(d["d_date"] >= lo) & (d["d_date"] <= hi)]
    order = cs["cs_order_number"]
    sel = np.isin(cs["cs_ship_date_sk"], dates) & \
        np.isin(cs["cs_ship_addr_sk"],
                ca["ca_address_sk"][ca["ca_state"] == state]) & \
        np.isin(cs["cs_call_center_sk"], cc["cc_call_center_sk"][
            np.isin(cc["cc_county"], Q16_COUNTIES)])
    # orders shipped from more than one warehouse: distinct (order,
    # warehouse) pairs, counted by order
    wh = cs["cs_warehouse_sk"].astype(np.int64)
    span = int(wh.max()) + 1 if len(wh) else 1
    pairs = np.unique(order.astype(np.int64) * span + wh)
    orders, n = np.unique(pairs // span, return_counts=True)
    sel &= np.isin(order, orders[n > 1])
    sel &= ~np.isin(order, tables["catalog_returns"]["cr_order_number"])
    any_row = bool(sel.any())
    return [{"order_count": int(len(np.unique(order[sel]))),
             "total_shipping_cost": float(cs["cs_ext_ship_cost"][sel].sum())
             if any_row else None,
             "total_net_profit": float(cs["cs_net_profit"][sel].sum())
             if any_row else None}]
